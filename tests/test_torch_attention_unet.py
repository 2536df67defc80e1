"""The port's attention U-Net path against the JAX package's: the gated
U-Net, its training on two channels, the attention loader, the image / mask
pair loader and the attention CLI.

Held, with the same seeded numpy inputs and the flax-initialised weights
carried by ``interop.from_jax.unet_state_dict_from_jax`` (a gated conv keeps
its ``2 ch`` outputs, features first, under the U-Net's keys):

- ``UNet(gated=True)`` on two channels, eval and train mode: outputs at
  rtol 1e-5 (atol 1e-6); the running statistics after the train-mode call
  at rtol 1e-5 (atol 1e-5 of each vector's largest entry);
- ``UNet2D.train`` of the gated net for one epoch of three steps on
  (image, attention) slices, dropout and augmentation off: the epoch loss
  at rtol 1e-5 and the weights as ``tests/test_torch_trainer2d.py`` holds
  them (Adam's bound for the conv biases before a BatchNorm);
- the config's augmentation on two channels with JAX's affine parameters
  injected: images within 1e-5, masks equal;
- ``load_segich_attention_2d`` on a tree written by the port, with the
  empty attention entries ``""``, ``"-"``, ``"None"`` and ``"nan"``, and
  ``load_img_mask_pairs`` on ``.png``, ``.tif`` and ``.bmp`` files, against
  the JAX loaders (pandas and PIL): images within 1e-6, masks equal;
- the attention CLI on a tree built from a detector-style export and the
  merge of its ``info.csv``: its folds are scikit-learn's
  ``StratifiedKFold``'s, as the JAX script draws them, and its artifacts.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import StratifiedKFold

from ich_tpu.data.datasets import load_img_mask_pairs as jax_load_pairs
from ich_tpu.data.datasets import load_segich_attention_2d as jax_load_attention
from ich_tpu.interop.torch_port import port_unet
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.ops import transforms as JT
from ich_tpu.train.segmentation2d import UNet2D as JaxUNet2D
from ich_tpu_torch.data.bmp import save_bmp_gray
from ich_tpu_torch.data.core import SliceDataset2D
from ich_tpu_torch.data.datasets import load_img_mask_pairs, load_segich_attention_2d
from ich_tpu_torch.data.png import save_png_gray
from ich_tpu_torch.data.synthetic import synthetic_ich_slices, write_segich_tree
from ich_tpu_torch.data.table import read_csv
from ich_tpu_torch.data.tiff import write_tiff
from ich_tpu_torch.experiments import attention_unet2d
from ich_tpu_torch.experiments.ad_inpainting import save_attention_map, write_attention_info
from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.train.segmentation2d import UNet2D
from ich_tpu_torch.utils.rng import prng_key

torch.set_num_threads(2)

NET = dict(depth=3, top_filter=4, midchannels_factor=2, norm="batch", p_dropout=0.0)
TRAIN = dict(n_epoch=1, batch_size=8, lr=1e-3, lr_scheduler="ExponentialLR",
             lr_scheduler_kwargs={"gamma": 0.5}, loss_fn="BinaryDiceLoss",
             loss_fn_kwargs={"reduction": "mean", "p": 2, "alpha": 0.2}, weight_decay=1e-6,
             seed=0)
AUGMENT = {"Translate": {"low": -0.1, "high": 0.1}, "Rotate": {"low": -10, "high": 10},
           "Scale": {"low": 0.9, "high": 1.1}, "HFlip": {"p": 0.5}}


def _two_channel(n=24, seed=1):
    """Synthetic slices with a second channel: a blurred copy of the mask
    plus noise, as an anomaly map would be."""
    ds = synthetic_ich_slices(n_slices=n, size=32, n_volumes=3, seed=seed, positive_frac=0.6)
    rng = np.random.default_rng(seed)
    att = np.clip(ds.masks * 0.8 + rng.uniform(0, 0.3, ds.masks.shape), 0, 1)
    return SliceDataset2D(np.stack([ds.images, att], axis=-1).astype(np.float32), ds.masks,
                          ds.vol_ids, ds.slice_nbrs)


def _gated_pair():
    jn = JaxUNet(gated=True, **NET)
    x = jnp.zeros((1, 32, 32, 2))
    v = jax.tree_util.tree_map(np.array, dict(jn.init(jax.random.PRNGKey(0), x)))
    net = UNet(gated=True, in_channels=2, **NET)
    sd = unet_state_dict_from_jax(v)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    return jn, v, net


def test_gated_unet_matches_flax():
    jn, v, net = _gated_pair()
    assert net.down_block[0].conv1.weight.shape == (4, 2, 3, 3)  # 2 x mid: features, gate
    x = _two_channel(4).images
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = np.asarray(jn.apply(v, jnp.asarray(x)))
    got = net.eval()(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want_t, mut = jn.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got_t = net.train()(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=1e-5, atol=1e-6)
    stats = unet_state_dict_from_jax({"params": v["params"], "batch_stats": jax.tree_util.
                                      tree_map(np.array, mut["batch_stats"])})
    for k, a in stats.items():
        if "running" in k:
            np.testing.assert_allclose(net.state_dict()[k].numpy(), a, rtol=1e-5,
                                       atol=1e-5 * np.abs(a).max(), err_msg=k)


def _leaves(variables):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(variables)}


def test_gated_unet_train_step_matches_jax():
    """One epoch of three steps (24 two-channel slices, batch 8)."""
    ds = _two_channel()
    jt = JaxUNet2D(JaxUNet(gated=True, **NET), **TRAIN)
    jt._ensure_state((32, 32, 2), 3)
    v0 = jax.tree_util.tree_map(np.array, jt._variables())
    net = UNet(gated=True, in_channels=2, **NET)
    net.load_state_dict({k: torch.from_numpy(np.array(a))
                         for k, a in unet_state_dict_from_jax(v0).items()})
    pt = UNet2D(net, device="cpu", **TRAIN)
    jt.train(ds)
    pt.train(ds)
    np.testing.assert_allclose([r[1] for r in pt.outputs["train"]["evolution"]],
                               [r[1] for r in jt.outputs["train"]["evolution"]], rtol=1e-5)
    drift = 2.0 * 3 * 1e-3
    want = _leaves(jax.tree_util.tree_map(np.asarray, jt._variables()))
    got = _leaves(port_unet({k: t.numpy() for k, t in pt.unet.state_dict().items()}))
    assert want.keys() == got.keys()
    for k, w in want.items():
        d = np.abs(got[k] - w)
        if ("batch_stats" in k and k.endswith("['mean']")) or ("['conv" in k
                                                                and k.endswith("['bias']")):
            assert d.max() <= drift, k
        elif "batch_stats" in k:
            np.testing.assert_allclose(got[k], w, rtol=1e-4, err_msg=k)
        elif "['conv" in k:
            assert np.mean(d <= 2e-5) >= 0.95 and d.max() <= 2e-4, (k, d.max())
        else:
            assert d.max() <= 2e-5, (k, d.max())


def test_two_channel_augmentation_matches_jax():
    """Both channels warped at order 1 and the mask at order 0 by one
    affine, JAX's parameters injected into both packages' transforms."""
    ds = _two_channel(8, seed=3)
    b, hw = 8, (32, 32)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    jts = [getattr(JT, n)(**kw) for n, kw in AUGMENT.items()]
    pts = [getattr(T, n)(**kw) for n, kw in AUGMENT.items()]
    for k, jt, pt in zip(keys, jts, pts):
        mt, ot = (np.array(a) for a in jt.affine_params(k, b, hw))
        jt.affine_params = lambda key, bb, hhww, mt=mt, ot=ot: (jnp.asarray(mt), jnp.asarray(ot))
        pt.affine_params = (lambda key, bb, hhww, mt=mt, ot=ot:
                            (torch.from_numpy(mt), torch.from_numpy(ot)))
    want_i, want_m = JT.Compose(*jts)(jax.random.PRNGKey(0), jnp.asarray(ds.images),
                                      jnp.asarray(ds.masks[..., None]))
    got_i, got_m = T.Compose(*pts)(prng_key(0), torch.from_numpy(ds.images),
                                   torch.from_numpy(ds.masks[..., None]))
    assert got_i.shape == (8, 32, 32, 2)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


# -- loaders ---------------------------------------------------------------------------


def merge_attention_info(data_dir: str, export_dir: str, blanks=()) -> None:
    """``data_dir/info.csv``: the rows of ``ct_info.csv`` with the export's
    ``attention_fn`` (made relative to ``data_dir``) merged in by
    (PatientNumber, SliceNumber); row ``i`` of ``blanks`` (index, text)
    gets ``text`` in place of its map."""
    export = {(r["PatientNumber"], r["SliceNumber"]): r["attention_fn"]
              for r in read_csv(os.path.join(export_dir, "info.csv")).to_dict("records")}
    rel = os.path.relpath(export_dir, data_dir)
    blank = dict(blanks)
    with open(os.path.join(data_dir, "ct_info.csv"), newline="") as f:
        rows = list(csv.reader(f))
    with open(os.path.join(data_dir, "info.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(rows[0] + ["attention_fn"])
        for i, r in enumerate(rows[1:]):
            att = os.path.join(rel, export[(int(r[1]), int(r[2]))])
            w.writerow(r + [blank.get(i, att)])


def _attention_tree(root, n_slices=12, n_volumes=4, seed=5):
    """A SegICH 2D tree with one attention PNG per slice in the layout of
    ``ad_inpainting --export-attention`` (under ``attention/``) and the
    merged ``info.csv``; four rows carry the empty entries."""
    ds = synthetic_ich_slices(n_slices=n_slices, size=40, n_volumes=n_volumes, seed=seed,
                              positive_frac=0.5)
    write_segich_tree(ds, root)
    export = os.path.join(root, "attention")
    rng = np.random.default_rng(seed)
    rows = [(int(v), int(s), save_attention_map(export, int(v), int(s),
                                                rng.uniform(0, 0.9, (40, 40))))
            for v, s in zip(ds.vol_ids, ds.slice_nbrs)]
    write_attention_info(export, rows)
    merge_attention_info(root, export, blanks=[(1, ""), (2, "-"), (3, "None"), (4, "nan")])
    return ds


def test_load_segich_attention_2d_matches_jax(tmp_path):
    root = str(tmp_path / "tree")
    ds = _attention_tree(root)
    got = load_segich_attention_2d(root, size=32)
    want = jax_load_attention(root, size=32)
    assert got.images.shape == (12, 32, 32, 2)
    np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(got.vol_ids, want.vol_ids)
    np.testing.assert_array_equal(got.slice_nbrs, want.slice_nbrs)
    assert not got.images[1:5, ..., 1].any() and got.images[0, ..., 1].max() > 0.5
    assert got.masks.max() == 1.0 and np.array_equal(got.vol_ids, ds.vol_ids)
    table = read_csv(os.path.join(root, "info.csv"))
    sub = load_segich_attention_2d(root, table[np.asarray(table["PatientNumber"]) == 1], size=24)
    assert len(sub) == 3 and sub.images.shape == (3, 24, 24, 2)


def test_load_img_mask_pairs_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    pairs = []
    for i, ext in enumerate((".png", ".tif", ".bmp")):
        img = rng.integers(0, 256, (30, 26)).astype(np.uint8)
        mask = (rng.uniform(size=(30, 26)) > 0.7).astype(np.uint8) * 255
        im_fn, m_fn = str(tmp_path / f"im{i}{ext}"), str(tmp_path / f"m{i}.png")
        if ext == ".png":
            save_png_gray(im_fn, img)
        elif ext == ".tif":
            write_tiff(im_fn, (img / 255.0).astype(np.float32))  # already in [0, 1]
        else:
            save_bmp_gray(im_fn, img)
        save_png_gray(m_fn, mask)
        pairs.append((im_fn, m_fn))
    for size in (None, 24):
        got, want = load_img_mask_pairs(pairs, size), jax_load_pairs(pairs, size)
        np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.masks, want.masks)
        np.testing.assert_array_equal(got.vol_ids, [0, 1, 2])
    assert got.images.shape == (3, 24, 24) and float(got.images.max()) <= 1.0


# -- the CLI -------------------------------------------------------------------------------


def test_attention_unet2d_cli_runs_on_the_merged_export(tmp_path):
    root = str(tmp_path / "tree")
    ds = _attention_tree(root, n_slices=16, n_volumes=4, seed=6)
    with open("configs/unet2d.json") as f:
        cfg = json.load(f)
    cfg["exp_name"] = "att"
    cfg["path"] = {"DATA": root, "OUTPUT": str(tmp_path / "out")}
    cfg["data"]["size"] = 32
    cfg["split"]["n_fold"] = 2
    cfg["net"].update(depth=3, top_filter=4)
    cfg["train"].update(n_epoch=1, batch_size=4)
    fn = str(tmp_path / "cfg.json")
    with open(fn, "w") as f:
        json.dump(cfg, f)
    out = attention_unet2d.main([fn, "--device", "cpu"])
    for name in ("average_scores.txt", "all_volume_prediction.csv", "config.json"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "config.json")) as f:
        net = json.load(f)["net"]
    assert net["gated"] is True and net["in_channels"] == 2

    # the folds: scikit-learn's StratifiedKFold over the patients' lesion flags
    vols = np.unique(ds.vol_ids)
    has = np.asarray([ds.masks[ds.vol_ids == v].max() > 0 for v in vols]).astype(int)
    skf = StratifiedKFold(n_splits=2, shuffle=True, random_state=42)
    for k, (_, te) in enumerate(skf.split(vols, has)):
        with open(os.path.join(out, f"Fold_{k + 1}", "pred", "volume_prediction_scores.csv"),
                  newline="") as f:
            tested = sorted(int(r["volID"]) for r in csv.DictReader(f))
        assert tested == sorted(vols[te].tolist()), k
    weights = torch.load(os.path.join(out, "Fold_1", "trained_unet.bin"), weights_only=True)
    assert weights["down_block.0.conv1.weight"].shape[:2] == (2 * 4, 2)
