"""``UNet2D.train`` and ``evaluate`` of the port against the JAX package's
trainer, from the same flax-initialised weights (carried over by
``unet_state_dict_from_jax``), on the same synthetic slices; and the
port's resume, transfer and serve-after-train behaviour."""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from ich_tpu.data import synthetic_ich_slices as jax_synthetic_ich_slices
from ich_tpu.interop.torch_port import port_unet
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.train.segmentation2d import UNet2D as JaxUNet2D
from ich_tpu_torch.data.synthetic import synthetic_ich_slices
from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops.transforms import build_pipeline
from ich_tpu_torch.train import checkpoint as ckpt
from ich_tpu_torch.train.segmentation2d import UNet2D

torch.set_num_threads(2)

NET = dict(depth=3, top_filter=8, midchannels_factor=2, norm="batch")
LR, GAMMA = 1e-3, 0.5
TRAIN = dict(n_epoch=2, batch_size=8, lr=LR, lr_scheduler="ExponentialLR",
             lr_scheduler_kwargs={"gamma": GAMMA}, loss_fn="BinaryDiceLoss",
             loss_fn_kwargs={"reduction": "mean", "p": 2, "alpha": 0.2},
             weight_decay=1e-6, seed=0)
AUGMENT = {"Translate": {"low": -0.1, "high": 0.1}, "Rotate": {"low": -10, "high": 10},
           "Scale": {"low": 0.9, "high": 1.1}, "HFlip": {"p": 0.5}}


def _data(seed=1, n=24, positive_frac=0.6):
    kw = dict(n_slices=n, size=32, n_volumes=3, seed=seed, positive_frac=positive_frac)
    port, jax_ds = synthetic_ich_slices(**kw), jax_synthetic_ich_slices(**kw)
    np.testing.assert_array_equal(port.images, jax_ds.images)
    return port, jax_ds


def _pair(variables=None, **train_kw):
    """A JAX trainer and a port trainer on the CPU holding the same weights
    (the JAX trainer's fresh init, or ``variables``)."""
    kw = {**TRAIN, **train_kw}
    jt = JaxUNet2D(JaxUNet(p_dropout=0.0, **NET), **kw)
    jt._ensure_state((32, 32), 3)
    if variables is not None:
        jt.state = jt.state.replace(params=variables["params"],
                                    batch_stats=variables["batch_stats"])
    v = jax.tree_util.tree_map(np.array, jt._variables())
    net = UNet(p_dropout=0.0, **NET)
    net.load_state_dict({k: torch.from_numpy(np.array(a))
                         for k, a in unet_state_dict_from_jax(v).items()})
    return jt, UNet2D(net, device="cpu", **kw), v


def _leaves(variables):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(variables)}


def test_train_matches_jax():
    """Two epochs of three steps (24 slices, batch 8, the host permutation
    of seed 0), dropout 0 and no augmentation.

    Tolerances: epoch losses rtol 1e-5. Adam's first update is about
    lr * sign(g), so a parameter whose gradient is rounding noise can move
    by up to lr a step in either package: the biases of the convs that
    feed a BatchNorm have a gradient of exactly 0 but for rounding (the
    norm subtracts the batch mean), so they and the running means they
    shift are held only to twice the sum of the step sizes. Conv kernels:
    95% of each within 2e-5 and all within 2e-4 (a few weights have
    near-zero gradients); BatchNorm scale and bias, the transposed convs
    and the final conv within 2e-5; running variances rtol 1e-4."""
    port_ds, jax_ds = _data()
    jt, pt, v0 = _pair()
    jt.train(jax_ds)
    pt.train(port_ds)
    assert not pt.unet.training  # back in eval mode for serving
    want = [row[1] for row in jt.outputs["train"]["evolution"]]
    got = [row[1] for row in pt.outputs["train"]["evolution"]]
    np.testing.assert_allclose(got, want, rtol=1e-5)

    drift = 2.0 * 3 * (LR + LR * GAMMA)
    want_v = _leaves(jax.tree_util.tree_map(np.asarray, jt._variables()))
    got_v = _leaves(port_unet({k: t.numpy() for k, t in pt.unet.state_dict().items()}))
    start = _leaves(v0)
    assert want_v.keys() == got_v.keys()
    for k, w in want_v.items():
        d = np.abs(got_v[k] - w)
        if "batch_stats" in k and k.endswith("['mean']"):
            assert d.max() <= drift, k
        elif "batch_stats" in k:
            np.testing.assert_allclose(got_v[k], w, rtol=1e-4, err_msg=k)
        elif "['conv" in k and k.endswith("['bias']"):
            assert d.max() <= drift, k
        elif "['conv" in k:
            assert np.mean(d <= 2e-5) >= 0.95 and d.max() <= 2e-4, (k, d.max())
        else:
            assert d.max() <= 2e-5, (k, d.max())
        if "batch_stats" not in k:
            assert np.abs(w - start[k]).max() > 0, k  # every parameter trained


def _calibrated_variables(ds):
    """Fresh flax weights with non-trivial running statistics and the final
    bias shifted so that about a fifth of the pixels are predicted
    positive: the counts then say something."""
    rng = np.random.default_rng(0)
    jt = JaxUNet2D(JaxUNet(p_dropout=0.0, **NET), **TRAIN)
    jt._ensure_state((32, 32), 3)
    v = jax.tree_util.tree_map(np.array, jt._variables())

    def stat(path, a):
        if "mean" in jax.tree_util.keystr(path):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    v["batch_stats"] = jax.tree_util.tree_map_with_path(stat, v["batch_stats"])
    net = UNet(p_dropout=0.0, use_final_activation=False, **NET).eval()
    net.load_state_dict({k: torch.from_numpy(np.array(a))
                         for k, a in unet_state_dict_from_jax(v).items()})
    with torch.no_grad():
        logits = net(torch.from_numpy(ds.images[:, None]))
    v["params"]["final_conv"]["bias"] -= np.float32(np.quantile(logits.numpy(), 0.8))
    return v


def _read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("positive_frac", [0.6, 0.0])
def test_evaluate_matches_jax(tmp_path, positive_frac):
    """Same weights: the slice and volume CSVs are the same text (columns,
    pandas' index, row order, counts and float formatting), the BMPs the
    same pixels, the Dice means within 1e-12; with no positive volume the
    positive Dice is NaN in both. 20 slices at batch 8: the wrapped tail
    batch's duplicates are dropped."""
    port_ds, jax_ds = _data(seed=4, n=20, positive_frac=positive_frac)
    jt, pt, _ = _pair(_calibrated_variables(port_ds))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    df = jt.evaluate(jax_ds, save_path=jdir)
    rows = pt.evaluate(port_ds, save_path=pdir)
    for name in ("slice_prediction_scores.csv", "volume_prediction_scores.csv"):
        assert _read(os.path.join(pdir, name)) == _read(os.path.join(jdir, name)), name
    assert len(rows["Dice"]) == len(df) == 20
    assert 0 < df.TP.sum() + df.FP.sum() < df[["TP", "TN", "FP", "FN"]].values.sum()
    from PIL import Image

    for vid, snb in zip(port_ds.vol_ids, port_ds.slice_nbrs):
        rel = f"{vid}/{snb}.bmp"
        want = np.asarray(Image.open(os.path.join(jdir, rel)))
        got = np.asarray(Image.open(os.path.join(pdir, rel)))
        np.testing.assert_array_equal(got, want)
    want_d, got_d = jt.outputs["eval"]["dice"], pt.outputs["eval"]["dice"]
    np.testing.assert_allclose(got_d["all"], want_d["all"], rtol=1e-12)
    if positive_frac == 0.0:
        assert np.isnan(want_d["positive"]) and np.isnan(got_d["positive"])
    else:
        np.testing.assert_allclose(got_d["positive"], want_d["positive"], rtol=1e-12)


def _port_trainer(n_epoch, p_dropout=0.5, augment=True, **kw):
    torch.manual_seed(3)
    net = UNet(p_dropout=p_dropout, **NET)
    return UNet2D(net, device="cpu", augment_fn=build_pipeline(AUGMENT) if augment else None,
                  **{**TRAIN, "n_epoch": n_epoch, **kw})


def test_resume_replays_the_uninterrupted_run(tmp_path, caplog):
    """Augmentation and dropout on: two epochs, a checkpoint, a resume to
    four, bit-equal to four straight epochs (weights, running statistics
    and epoch losses)."""
    ds = synthetic_ich_slices(n_slices=20, size=32, n_volumes=3, seed=2).device_cache("cpu")
    path = str(tmp_path / "ckpt.bin")
    _port_trainer(2, checkpoint_freq=2).train(ds, checkpoint_path=path)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    resumed = _port_trainer(4, checkpoint_freq=2)
    with caplog.at_level("INFO"):
        resumed.train(ds, checkpoint_path=path)
    assert any("Checkpoint loaded with 2 epoch finished" in r.message for r in caplog.records)
    straight = _port_trainer(4)
    straight.train(ds)
    assert resumed.outputs["train"]["evolution"] == straight.outputs["train"]["evolution"]
    assert resumed.state.step == straight.state.step == 12
    for (k, a), b in zip(resumed.unet.state_dict().items(), straight.unet.state_dict().values()):
        assert torch.equal(a, b), k
    # dropout and augmentation did draw: without them the losses differ
    plain = _port_trainer(4, p_dropout=0.0, augment=False)
    plain.train(ds)
    assert plain.outputs["train"]["evolution"] != straight.outputs["train"]["evolution"]


def test_checkpoint_file_round_trip_and_missing_file(tmp_path):
    assert ckpt.load_checkpoint(str(tmp_path / "none.bin")) is None
    t = _port_trainer(1)
    t.train(synthetic_ich_slices(n_slices=8, size=32, n_volumes=2, seed=0))
    path = str(tmp_path / "sub" / "c.bin")
    ckpt.save_checkpoint(path, t.state.state_dict(), 1, [[1, 0.5, None, None]])
    state, epoch, history = ckpt.load_checkpoint(path)
    assert epoch == 1 and history == [[1, 0.5, None, None]] and state["step"] == 1
    for k, v in t.unet.state_dict().items():
        assert torch.equal(state["model"][k], v)
    assert state["optimizer"]["param_groups"][0]["weight_decay"] == TRAIN["weight_decay"]


def test_transfer_weights_applies_and_survives_training():
    """The port's net exists from construction, so a transfer made before
    ``train`` (where the JAX trainer defers it) is in the weights that
    training starts from; a transfer that matches nothing raises."""
    src_net = UNet(p_dropout=0.0, **NET)
    src = {k: v + 1.0 if v.is_floating_point() else v
           for k, v in src_net.state_dict().items() if k.startswith("down_block.0.")}
    t = _port_trainer(1, lr=0.0, weight_decay=0.0)
    moved = t.transfer_weights(src, verbose=True)
    assert sorted(moved) == sorted(src)
    for k in moved:
        if "running" not in k and "num_batches" not in k:
            assert torch.equal(t.unet.state_dict()[k], src[k]), k
    t.train(synthetic_ich_slices(n_slices=8, size=32, n_volumes=2, seed=0))
    w = t.unet.state_dict()["down_block.0.conv1.weight"]
    assert torch.equal(w, src["down_block.0.conv1.weight"])  # lr 0: the weight stays
    with pytest.raises(ValueError, match="none of the"):
        t.transfer_weights({"nope.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="none of the"):
        t.transfer_weights({"down_block.0.conv1.weight": torch.zeros(3, 3)})


def test_serves_after_training(tmp_path):
    """The same trainer object segments volumes after ``train``, in eval
    mode, the same as a serving-only ``UNet2D`` with its weights."""
    t = _port_trainer(1)
    t.train(synthetic_ich_slices(n_slices=8, size=32, n_volumes=2, seed=0))
    vol = np.random.default_rng(0).uniform(-50, 150, size=(40, 36, 5)).astype(np.float32)
    got = t.segment_volume(vol, window=(50, 200), input_size=(32, 32), return_pred=True)
    fn = str(tmp_path / "m.pt")
    t.save_model(fn)
    serve = UNet2D(UNet(p_dropout=0.5, **NET), batch_size=8, device="cpu")
    serve.load_model(fn)
    want = serve.segment_volume(vol, window=(50, 200), input_size=(32, 32), return_pred=True)
    np.testing.assert_array_equal(got, want)
    assert got.shape == vol.shape and set(np.unique(got)) <= {0, 255}
