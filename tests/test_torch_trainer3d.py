"""The port's 3D patch trainer (``UNet3D.train``, its step, ``evaluate``
after training, the CLI) against the JAX package's, from the same
flax-initialised d3 f4 GroupNorm weights (``unet_state_dict_from_jax``), on
the CPU; and the port's resume, remat and validation-mode behaviour.

Tolerances: losses rtol 1e-5 for one step and 1e-4 over two epochs; every
weight within Adam's bound of the JAX package's (its first update is about
lr * sign(g), so a weight whose gradient is rounding noise may land up to
2 lr a step away) and most much closer (``_check_weights``); evaluation
counts equal, Dice and IoU within 1e-6."""

import csv
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.data.core import VolumeDataset3D as JaxVolumeDataset3D
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.ops import transforms3d as JT3
from ich_tpu.train.segmentation3d import UNet3D as JaxUNet3D
from ich_tpu_torch.data import nifti
from ich_tpu_torch.data.core import VolumeDataset3D
from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax
from ich_tpu_torch.models.layers import set_dropout_keys
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.ops import transforms3d as T3
from ich_tpu_torch.ops.transforms3d import default_patch_augmentation
from ich_tpu_torch.train.segmentation3d import UNet3D
from ich_tpu_torch.utils.rng import prng_key

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = (16, 16, 16)
NET = dict(depth=3, ndim=3, top_filter=4, midchannels_factor=1, norm="group")
LR = 1e-3
TRAIN = dict(patch_size=PATCH, steps_per_epoch=3, pos_frac=0.5, n_epoch=2, batch_size=2,
             lr=LR, loss_fn="BinaryDiceLoss",
             loss_fn_kwargs={"reduction": "mean", "p": 2, "alpha": 0.2}, seed=0)


def _volumes(seed, shapes=((20, 32, 32), (12, 24, 28), (18, 14, 32))):
    """Windowed-intensity volumes with ellipsoid bleeds; the second is
    shorter than the patch along D, the third along H."""
    rng = np.random.default_rng(seed)
    vols, masks = [], []
    for d, h, w in shapes:
        zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
        c = rng.uniform(0.3, 0.7, 3) * (d, h, w)
        r = rng.uniform(3, 6, 3)
        m = ((((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
              + ((xx - c[2]) / r[2]) ** 2) <= 1).astype(np.float32)
        v = 0.35 + 0.08 * rng.standard_normal((d, h, w))
        vols.append(np.clip(np.where(m > 0, 0.75, v), 0, 1).astype(np.float32))
        masks.append(m)
    return vols, masks


def _datasets(seed=0):
    vols, masks = _volumes(seed)
    ids = np.asarray([3, 7, 11])
    return VolumeDataset3D(vols, masks, ids), JaxVolumeDataset3D(vols, masks, ids)


def _pair(p_dropout=0.0, **kw):
    """A JAX trainer (its fresh flax init) and a port trainer on the CPU
    holding the same weights."""
    kw = {**TRAIN, **kw}
    jt = JaxUNet3D(JaxUNet(p_dropout=p_dropout, **NET), **kw)
    jt._ensure_state(PATCH, kw["steps_per_epoch"])
    net = UNet(p_dropout=p_dropout, **NET)
    _load_jax(net, jt._variables())
    return jt, UNet3D(net, device="cpu", **kw)


def _load_jax(net, variables):
    v = jax.tree_util.tree_map(np.array, variables)
    net.load_state_dict({k: torch.from_numpy(np.array(a))
                         for k, a in unet_state_dict_from_jax(v).items()})


def _as_port(variables):
    """JAX variables as the port's ``state_dict`` (numpy)."""
    return unet_state_dict_from_jax(jax.tree_util.tree_map(np.array, variables))


def _check_weights(jax_vars, port_net, start, steps):
    """Every weight within Adam's bound of the JAX package's (2 lr a
    step); after one step 95% of each array within 2e-5, after more 95% of
    all weights within 1e-4 (noise-level gradients drift further apart
    with each step); every parameter moved."""
    want = _as_port(jax_vars)
    got = {k: t.numpy() for k, t in port_net.state_dict().items()}
    assert want.keys() == got.keys()
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * 1.005 * LR * steps + 1e-6, (k, d.max())
        if steps == 1:
            assert np.mean(d <= 2e-5) >= 0.95, (k, np.mean(d <= 2e-5))
        assert np.abs(w - start[k]).max() > 0, k
    d = np.concatenate([np.abs(got[k] - w).ravel() for k, w in want.items()])
    assert np.mean(d <= 1e-4) >= 0.95, np.mean(d <= 1e-4)


def _fixed_augment(b):
    """One in-plane warp and one brightness jitter with fixed parameters,
    for both packages."""
    th = np.deg2rad(np.asarray([7.0, -12.0][:b], np.float32))
    m = np.stack([np.stack([np.cos(th), np.sin(th)], 1),
                  np.stack([-np.sin(th), -np.cos(th)], 1)], 1).astype(np.float32)
    o = np.zeros((b, 2), np.float32)
    apply, f = np.asarray([True, False][:b]), np.asarray([0.08, 0.05][:b], np.float32)

    def jax_fn(key, x, y):
        mj, oj = jnp.asarray(m), jnp.asarray(o)
        x = JT3._warp_inplane(x, mj, oj, 12.0, 1)
        y = JT3._warp_inplane(y, mj, oj, 12.0, 0)
        x = jnp.where(jnp.asarray(apply)[:, None, None, None, None],
                      jnp.clip(x + jnp.asarray(f)[:, None, None, None, None], 0, 1), x)
        return x, y

    def port_fn(key, x, y):
        mt, ot = torch.from_numpy(m), torch.from_numpy(o)
        x, y = T3._warp_inplane(x, mt, ot, 1), T3._warp_inplane(y, mt, ot, 0)
        x = T.AdjustBrightness().apply_factors(x, torch.from_numpy(apply), torch.from_numpy(f))
        return x, y

    return jax_fn, port_fn


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_one_step_matches_jax(augment):
    """One step from the same weights on the same (B, D, H, W) patches:
    the loss at rtol 1e-5 and the weights within Adam's bound."""
    port_ds, _ = _datasets()
    v, m = port_ds.volumes[0], port_ds.masks[0]
    crops = (np.s_[:16, :16, :16], np.s_[4:20, 8:24, 12:28])
    imgs, msks = np.stack([v[c] for c in crops]), np.stack([m[c] for c in crops])
    assert msks.any()
    jax_aug, port_aug = _fixed_augment(2) if augment else (None, None)
    jt, pt = _pair(augment_fn=None)
    jt.augment_fn, pt.augment_fn = jax_aug, port_aug
    start = _as_port(jt._variables())
    step = jt._make_train_step()
    jt.state, want = step(jt.state, jnp.asarray(imgs), jnp.asarray(msks), jax.random.PRNGKey(0))
    state = pt._train_state(TRAIN["steps_per_epoch"])
    pt.unet.train()
    got = pt._step(state, torch.from_numpy(imgs), torch.from_numpy(msks), prng_key(0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _check_weights(jt._variables(), pt.unet, start, 1)


@pytest.fixture(scope="module")
def trained():
    """Two epochs of three steps with the host sampler in both packages
    (the same numpy draws, so the same patches), no augmentation."""
    port_ds, jax_ds = _datasets()
    jt, pt = _pair(on_device_sampling=False)
    start = _as_port(jt._variables())
    jt.train(jax_ds)
    pt.train(port_ds)
    return jt, pt, start


def test_two_epochs_host_sampler_match_jax(trained):
    jt, pt, start = trained
    want = [row[1] for row in jt.outputs["train"]["evolution"]]
    got = [row[1] for row in pt.outputs["train"]["evolution"]]
    assert len(got) == 2 and got[0] != got[1]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert pt.state.step == 6 and not pt.unet.training
    _check_weights(jt._variables(), pt.unet, start, 6)


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_evaluate_after_training_matches_jax(trained, tmp_path):
    """The trained JAX weights in the port: the same CSV (index, ids,
    labels and counts as text; Dice and IoU within 1e-6) and scores; one
    test volume without a bleed."""
    jt, pt, _ = trained
    vols, masks = _volumes(5, shapes=((20, 32, 32), (16, 24, 24), (16, 16, 16)))
    masks[2][:] = 0
    ids = np.asarray([4, 1, 9])
    _load_jax(pt.unet, jt._variables())
    jt.evaluate(JaxVolumeDataset3D(vols, masks, ids), save_path=str(tmp_path / "jax"))
    pt.evaluate(VolumeDataset3D(vols, masks, ids), save_path=str(tmp_path / "port"))
    want = _read_csv(tmp_path / "jax" / "volume_prediction_scores.csv")
    got = _read_csv(tmp_path / "port" / "volume_prediction_scores.csv")
    assert got[0] == want[0] and len(got) == len(want) == 4
    for g, w in zip(got[1:], want[1:]):
        assert g[:7] == w[:7]
        np.testing.assert_allclose([float(x) for x in g[7:]], [float(x) for x in w[7:]],
                                   rtol=0, atol=1e-6)
    assert any(float(r[3]) > 0 for r in got[1:])  # some TP: a real prediction
    for key in ("dice", "iou"):
        for part in ("all", "positive"):
            assert abs(pt.outputs["eval"][key][part] - jt.outputs["eval"][key][part]) <= 1e-6


def _port_trainer(n_epoch, p_dropout=0.3, norm="group", **kw):
    torch.manual_seed(3)
    net = UNet(p_dropout=p_dropout, **{**NET, "norm": norm})
    return UNet3D(net, device="cpu", augment_fn=default_patch_augmentation(flip_axes=(1, 2, 3)),
                  **{**TRAIN, "n_epoch": n_epoch, **kw})


def test_resume_replays_the_uninterrupted_run(tmp_path, caplog):
    """Device sampler (on the CPU), augmentation and dropout on: one epoch,
    a checkpoint, a resume to two, bit-equal to two straight epochs."""
    port_ds, _ = _datasets(1)
    path = str(tmp_path / "ckpt.bin")
    _port_trainer(1, checkpoint_freq=1).train(port_ds, checkpoint_path=path)
    resumed = _port_trainer(2, checkpoint_freq=1)
    with caplog.at_level("INFO"):
        resumed.train(port_ds, checkpoint_path=path)
    assert any("Checkpoint loaded with 1 epoch finished" in r.message for r in caplog.records)
    assert any("On-device patch sampling" in r.message for r in caplog.records)
    straight = _port_trainer(2)
    straight.train(port_ds)
    assert resumed.outputs["train"]["evolution"] == straight.outputs["train"]["evolution"]
    assert resumed.state.step == straight.state.step == 6
    for (k, a), b in zip(resumed.unet.state_dict().items(), straight.unet.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("norm,p_dropout", [("group", 0.0), ("batch", 0.3)])
def test_remat_matches_plain(norm, p_dropout):
    """``remat=True``: the same ``state_dict`` keys; one forward and
    backward in train mode with the same dropout key gives equal
    gradients, and BatchNorm's running statistics are updated once, equal
    to the plain net's (torch.equal); the blocks do run twice."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 1) + PATCH)
                         .astype(np.float32))
    out = {}
    for remat in (False, True):
        torch.manual_seed(0)
        net = UNet(p_dropout=p_dropout, remat=remat, **{**NET, "norm": norm}).train()
        set_dropout_keys(net, prng_key(1))
        calls = []
        net.down_block[0].conv1.register_forward_hook(lambda *a: calls.append(1))
        net(x).square().mean().backward()
        out[remat] = (net, len(calls))
    (plain, n_plain), (remat, n_remat) = out[False], out[True]
    assert list(plain.state_dict()) == list(remat.state_dict())
    assert (n_plain, n_remat) == (1, 2)
    for (k, a), b in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(a.grad, b.grad), k
    for (k, a), b in zip(plain.named_buffers(), remat.buffers()):
        assert torch.equal(a, b), k
    if norm == "batch":
        assert not torch.equal(plain.down_block[0].bn1.running_mean, torch.zeros(4))


def test_validation_in_training_is_eval_mode():
    """With dropout on, the validation Dice of the last epoch equals a
    separate ``evaluate`` after training (the net validates in eval mode),
    and ``evaluate`` called in train mode leaves the net in train mode."""
    port_ds, _ = _datasets(2)
    t = _port_trainer(2, p_dropout=0.5)
    t.train(port_ds, valid_dataset=port_ds)
    last = t.outputs["train"]["evolution"][-1]
    assert not t.unet.training
    t.evaluate(port_ds)
    assert last[2] == t.outputs["eval"]["dice"]["all"]
    assert last[3] == t.outputs["eval"]["dice"]["positive"]
    t.unet.train()
    t.evaluate(port_ds)
    assert t.unet.training
    assert last[2] == t.outputs["eval"]["dice"]["all"]


def test_sampler_choice(caplog, monkeypatch):
    """``auto``: the device sampler, or the host one for a mask that is not
    binary or a stack beyond the budget, each logged; ``True`` raises on a
    mask that is not binary; no other value is accepted."""
    port_ds, _ = _datasets()
    port_ds.masks[0] = port_ds.masks[0] * 2.0
    port_ds.masks[0][0, 0, 0] = 1.0
    t = _port_trainer(1, p_dropout=0.0, steps_per_epoch=1)
    with caplog.at_level("INFO"):
        assert t._device_sampler(port_ds) is None
    assert "a mask is not binary" in caplog.text
    forced = _port_trainer(1, p_dropout=0.0, steps_per_epoch=1, on_device_sampling=True)
    with pytest.raises(ValueError, match="binary masks"):
        forced.train(port_ds)
    good, _ = _datasets()
    assert t._device_sampler(good) is not None
    monkeypatch.setattr("ich_tpu_torch.train.segmentation3d.DEVICE_SAMPLER_BUDGET", 1000)
    with caplog.at_level("INFO"):
        assert t._device_sampler(good) is None
    assert "budget" in caplog.text
    with pytest.raises(ValueError, match="on_device_sampling"):
        UNet3D(UNet(p_dropout=0.0, **NET), device="cpu", on_device_sampling="yes")


def _write_segich3d_tree(root, n=5):
    """``ct_scans/<pid>.nii`` (HU) and ``masks/<pid>.nii`` at spacing
    (0.5, 0.5, 5.0), as ``load_segich_3d`` reads them."""
    affine = np.diag([0.5, 0.5, 5.0, 1.0])
    vols, masks = _volumes(7, shapes=[(10, 32, 32)] * n)
    for pid, (v, m) in enumerate(zip(vols, masks), start=1):
        hwd = lambda a: np.transpose(a, (1, 2, 0))  # noqa: E731
        nifti.save(os.path.join(root, "ct_scans", f"{pid:03}.nii"),
                   (hwd(v) * 200.0 - 50.0).astype(np.int16), affine)
        nifti.save(os.path.join(root, "masks", f"{pid:03}.nii"), hwd(m).astype(np.uint8), affine)


def test_cli_runs_on_a_segich3d_tree(tmp_path):
    """``python -m ich_tpu_torch.experiments.supervised3d CONFIG.json
    --device cpu`` on five tiny volumes: the artifacts with the JAX
    script's names, one test volume in the CSV, and its last line."""
    _write_segich3d_tree(str(tmp_path / "data"))
    with open(os.path.join(ROOT, "configs", "unet3d.json")) as f:
        cfg = json.load(f)
    cfg["path"] = {"DATA": str(tmp_path / "data"), "OUTPUT": str(tmp_path / "out")}
    cfg["data"]["patch_size"] = [16, 16, 16]
    cfg["net"].update(depth=3, top_filter=4)
    cfg["train"].update(n_epoch=2, steps_per_epoch=2, batch_size=2, sw_batch_size=4)
    cfg_fn = str(tmp_path / "cfg.json")
    with open(cfg_fn, "w") as f:
        json.dump(cfg, f)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "ich_tpu_torch.experiments.supervised3d", cfg_fn,
                        "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = tmp_path / "out" / cfg["exp_name"]
    last = r.stdout.strip().splitlines()[-1]
    assert last.startswith("Dice (all): ") and last.endswith(f"; artifacts at {out}")
    for name in ("volume_prediction_scores.csv", "trained_unet3d.bin", "outputs.json"):
        assert (out / name).exists(), name
    rows = _read_csv(out / "volume_prediction_scores.csv")
    assert [r[1] for r in rows[1:]] == ["5"]
    with open(out / "outputs.json") as f:
        o = json.load(f)
    assert len(o["train"]["evolution"]) == 2 and o["eval"]["iou"]["all"] is not None
