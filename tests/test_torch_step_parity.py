"""The keyed train steps follow the JAX package's from one seed: the 2.5D
trainer with the config's augmentation, context restoration with its patch
swap, and global and local contrastive learning with the default SimCLR
views and the region cells, each built fresh in both packages from the
same seed, give the same first 10 losses within rtol 1e-4 on the CPU with
dropout 0, and the same first 3 with dropout 0.5 (flax's masks, drawn by
``ich_tpu_torch.ops.dropout``), as does the binary classifier; the nets start
equal (``tests/test_torch_init.py``), and after one step every parameter
sits within lr / 10 of the JAX package's for at least 98% of its elements
(Adam's first update is about lr times the gradient's sign, so a weight
whose gradient is rounding noise may move either way), but for the biases
of the convs that feed a BatchNorm, whose gradient is rounding noise
throughout (the norm subtracts the batch mean): they move by lr either
way and are held within 2 lr."""

import jax
import numpy as np
import pytest
import torch

import ich_tpu.train.classifier as jax_cls
from ich_tpu.data import synthetic_ich_slices as jax_synthetic_ich_slices
from ich_tpu.data import synthetic_rsna_slices as jax_synthetic_rsna_slices
from ich_tpu.interop.torch_port import port_partial_unet, port_unet, port_unet_encoder
from ich_tpu.models import PartialUNet as JaxPartialUNet
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.models import UNetEncoder as JaxUNetEncoder
from ich_tpu.ops import transforms as JT
from ich_tpu.train import ssl as jax_ssl
from ich_tpu.train.segmentation2d import UNet2D as JaxUNet2D
from ich_tpu_torch.data.core import LabeledSliceDataset
from ich_tpu_torch.data.synthetic import synthetic_ich_slices, synthetic_rsna_slices
from ich_tpu_torch.models.unet import PartialUNet, UNet, UNetEncoder
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.train import classifier as cls
from ich_tpu_torch.train import ssl
from ich_tpu_torch.train.segmentation2d import UNet2D
from ich_tpu_torch.utils.rng import prng_key

torch.set_num_threads(2)

SEED = 3
LR = 1e-3
NET = dict(depth=3, top_filter=4, midchannels_factor=2, p_dropout=0.0)
AUGMENT = {"Translate": {"low": -0.1, "high": 0.1}, "Rotate": {"low": -10, "high": 10},
           "Scale": {"low": 0.9, "high": 1.1}, "HFlip": {"p": 0.5}}
HW = (32, 32)


def _data(n, seed=1):
    kw = dict(n_slices=n, size=32, n_volumes=4, seed=seed)
    return synthetic_ich_slices(**kw), jax_synthetic_ich_slices(**kw)


def _losses(jt, pt):
    """Record each step's loss in both trainers, and both nets' variables
    after the first step (``jax1``, ``port1``)."""
    rec = {"jax": [], "port": []}
    make = jt._make_train_step

    def make_recording():
        step = make()

        def run(state, *args):
            state, loss = step(state, *args)
            rec["jax"].append(float(loss))
            if len(rec["jax"]) == 1:  # a copy: the next step donates the state
                rec["jax1"] = jax.tree_util.tree_map(np.array, state.variables())
            return state, loss

        return run

    jt._make_train_step = make_recording
    port_step = pt._train_step

    def run_port(state, batch, key):
        loss = port_step(state, batch, key)
        rec["port"].append(float(loss))
        if len(rec["port"]) == 1:
            rec["port1"] = {k: t.detach().clone().numpy()
                            for k, t in state.model.state_dict().items()}
        return loss

    pt._train_step = run_port
    return rec


def _held_after_one_step(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k, w in want.items():
        if "batch_stats" in k:
            continue
        d = np.abs(np.asarray(got[k]) - np.asarray(w))
        if "['conv" in k and k.endswith("['bias']"):
            assert d.max() <= 2 * LR, k
        else:
            assert np.mean(d <= LR / 10) >= 0.98, (k, float(np.mean(d <= LR / 10)))


def _leaves(variables):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(variables)}


def _seg_pair(n_epoch, net=NET):
    train = dict(n_epoch=n_epoch, batch_size=8, lr=LR, loss_fn="BinaryDiceLoss",
                 loss_fn_kwargs={"reduction": "mean", "p": 2, "alpha": 0.2}, seed=SEED)
    jt = JaxUNet2D(JaxUNet(norm="batch", **net), augment_fn=JT.Compose(
        *(getattr(JT, n)(**kw) for n, kw in AUGMENT.items())), **train)
    pt = UNet2D(UNet(norm="batch", key=prng_key(SEED), **net),
                augment_fn=T.build_pipeline(AUGMENT), device="cpu", **train)
    return jt, pt


@pytest.mark.parametrize("steps", [1, 10])
def test_2d_trainer_steps_follow_jax(steps):
    """10 steps: 40 slices in batches of 8 over two epochs; 1 step: the
    first batch of one epoch, then the weights."""
    port_ds, jax_ds = _data(40 if steps == 10 else 8)
    jt, pt = _seg_pair(2 if steps == 10 else 1)
    rec = _losses(jt, pt)
    jt.train(jax_ds)
    pt.train(port_ds)
    assert len(rec["jax"]) == len(rec["port"]) == steps
    np.testing.assert_allclose(rec["port"], rec["jax"], rtol=1e-4)
    if steps == 1:
        got = _leaves(port_unet({k: t.numpy() for k, t in pt.unet.state_dict().items()}))
        _held_after_one_step(_leaves(jax.tree_util.tree_map(np.asarray, jt._variables())), got)


def _ssl_pair(kind, n_epoch, net=NET):
    train = dict(n_epoch=n_epoch, batch_size=8, lr=LR, seed=SEED)
    if kind == "cr":
        swap = dict(n_swap=3, swap_w=(4, 8), swap_h=(4, 8), swap_rotate=True)
        jt = jax_ssl.ContextRestoration(JaxUNet(use_final_activation=False, **net), **swap,
                                        **train)
        pt = ssl.ContextRestoration(UNet(use_final_activation=False, key=prng_key(SEED), **net),
                                    device="cpu", **swap, **train)
        return jt, pt, port_unet
    if kind == "global":
        enc = dict(mlp_head=(16, 8), **net)
        jt = jax_ssl.Contrastive(JaxUNetEncoder(**enc), is_global=True, tau=0.5, **train)
        pt = ssl.Contrastive(UNetEncoder(key=prng_key(SEED), **enc), is_global=True, tau=0.5,
                             device="cpu", **train)
        return jt, pt, port_unet_encoder
    part = dict(n_decoder=1, head_channel=(8, 4), **net)
    jt = jax_ssl.Contrastive(JaxPartialUNet(**part), is_global=False, tau=0.5, K=2, n_region=4,
                             **train)
    pt = ssl.Contrastive(PartialUNet(key=prng_key(SEED), **part), is_global=False, tau=0.5, K=2,
                         n_region=4, device="cpu", **train)
    return jt, pt, port_partial_unet


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("kind", ["cr", "global", "local"])
def test_ssl_steps_follow_jax(kind, steps):
    """Context restoration (its real patch swap), global contrastive (the
    default views) and local contrastive (the views and the region cells):
    10 steps over two epochs of 40 slices, or one step of 8."""
    port_ds, jax_ds = _data(40 if steps == 10 else 8, seed=2)
    jt, pt, port_fn = _ssl_pair(kind, 2 if steps == 10 else 1)
    rec = _losses(jt, pt)
    jt.train(jax_ds)
    pt.train(port_ds)
    assert len(rec["jax"]) == len(rec["port"]) == steps
    np.testing.assert_allclose(rec["port"], rec["jax"], rtol=1e-4)
    if steps == 1:
        got = _leaves(port_fn({k: t.numpy() for k, t in pt.net.state_dict().items()}))
        _held_after_one_step(_leaves(jax.tree_util.tree_map(np.asarray, jt._variables())), got)


DROP_NET = {**NET, "p_dropout": 0.5}


def _dropout_pair(kind):
    """Both trainers of ``kind`` at dropout 0.5, one epoch of 3 steps, and
    the data and the converter of the port's weights."""
    if kind == "2d":
        port_ds, jax_ds = _data(24)
        return (*_seg_pair(1, DROP_NET), port_unet, port_ds, jax_ds)
    if kind == "classifier":
        train = dict(n_epoch=1, batch_size=8, lr=LR, seed=SEED, class_weight=[0.4, 1.6])
        enc = dict(mlp_head=(16, 2), **DROP_NET)
        jt = jax_cls.BinaryClassifier(JaxUNetEncoder(**enc), **train)
        pt = cls.BinaryClassifier(UNetEncoder(key=prng_key(SEED), **enc), device="cpu", **train)
        kw = dict(n_slices=24, size=32, seed=4)
        data, jdata = synthetic_rsna_slices(**kw), jax_synthetic_rsna_slices(**kw)
        labels = data.labels[:, 0].astype(np.int32)
        return (jt, pt, port_unet_encoder, LabeledSliceDataset(data.images, labels),
                type(jdata)(jdata.images, labels))
    port_ds, jax_ds = _data(24, seed=2)
    return (*_ssl_pair(kind, 1, DROP_NET), port_ds, jax_ds)


@pytest.mark.parametrize("kind", ["2d", "cr", "global", "local", "classifier"])
def test_steps_with_dropout_follow_jax(kind):
    """Dropout 0.5 in every encoder block: 3 steps of 8 slices, the
    losses within rtol 1e-4, and the weights after step 1 held by Adam's
    first-step rule."""
    jt, pt, port_fn, port_ds, jax_ds = _dropout_pair(kind)
    rec = _losses(jt, pt)
    jt.train(jax_ds)
    pt.train(port_ds)
    assert len(rec["jax"]) == len(rec["port"]) == 3
    np.testing.assert_allclose(rec["port"], rec["jax"], rtol=1e-4)
    _held_after_one_step(_leaves(rec["jax1"]), _leaves(port_fn(rec["port1"])))


def test_jax_init_is_the_port_init():
    """The premise of the step holds: both trainers start from the same
    net (the JAX trainer inits at PRNGKey(seed))."""
    jt, pt = _seg_pair(1)
    jt._ensure_state(HW, 1)
    want = _leaves(jax.tree_util.tree_map(np.asarray, jt._variables()))
    got = _leaves(port_unet({k: t.numpy() for k, t in pt.unet.state_dict().items()}))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=2e-6, atol=1e-9, err_msg=k)
