"""The port's 3D path (``UNet3D.segment_volume(s)``, ``evaluate``,
``python -m ich_tpu_torch.serve --mode 3d`` and ``load_segich_3d``) against
the JAX package's, with d3 f8 GroupNorm 3D U-Nets carried from flax
(``midchannels_factor`` 2, the bench net's, and 1, ``configs/unet3d.json``'s)
on synthetic head-CT volumes, on the CPU.

Tolerances: float32 probabilities within 1e-5 and masks agreeing on at
least 99.9% of voxels (only threshold flips at p ~ 0.5 may differ); bf16
against the JAX package's bf16 net, probabilities within 2e-2 and masks on
at least 99% (the two round at different places: JAX rounds GroupNorm's
scale and shift to bf16, torch's fused ``group_norm`` rounds once);
evaluation counts exactly equal, Dice and IoU within 1e-6.
"""

import csv
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ich_tpu.data.core import VolumeDataset3D as JaxVolumeDataset3D
from ich_tpu.data.datasets import load_segich_3d as jax_load_segich_3d
from ich_tpu.data.synthetic import synthetic_ich_volume
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.ops import ct as jct
from ich_tpu.ops import sliding_window as jsw
from ich_tpu.train.segmentation3d import UNet3D as JaxUNet3D
from ich_tpu_torch import serve
from ich_tpu_torch.data import nifti
from ich_tpu_torch.data.core import VolumeDataset3D
from ich_tpu_torch.data.datasets import load_segich_3d
from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import ct
from ich_tpu_torch.ops import sliding_window as sw
from ich_tpu_torch.train.segmentation3d import UNet3D

torch.set_num_threads(2)

PATCH = (16, 16, 16)
WINDOW = (50.0, 200.0)
NET = dict(depth=3, ndim=3, top_filter=8, norm="group", p_dropout=0.0)


def _volume(seed):
    """(D, H, W) = (20, 32, 32) HU volume and mask: D is not a multiple of
    the stride, so the coset path pads it."""
    vol, mask = synthetic_ich_volume(size=32, depth=20, seed=seed)
    return np.transpose(vol, (2, 0, 1)).copy(), np.transpose(mask, (2, 0, 1)).copy()


@pytest.fixture(scope="module")
def trainers():
    """``trainers(mf, bf16)`` -> (JAX UNet3D, port UNet3D) holding the same
    flax-initialised weights, built once per (mf, dtype) so the JAX
    programs compile once."""
    cache = {}

    def get(mf, bf16=False):
        if (mf, bf16) not in cache:
            kw = dict(NET, midchannels_factor=mf)
            jt = JaxUNet3D(JaxUNet(**kw, dtype=jnp.bfloat16 if bf16 else jnp.float32),
                           patch_size=PATCH, seed=mf)
            jt._ensure_state(PATCH)
            if bf16:  # the float32 net's weights, so bf16 and float32 compare too
                params = get(mf)[0].state.params
                jt.state = jt.state.replace(params=params)
            v = jax.tree_util.tree_map(np.asarray, jt._variables())
            net = UNet(**kw, dtype=torch.bfloat16 if bf16 else torch.float32)
            net.load_state_dict({k: torch.from_numpy(np.array(a))
                                 for k, a in unet_state_dict_from_jax(v).items()})
            cache[mf, bf16] = (jt, UNet3D(net, patch_size=PATCH, device="cpu"))
        return cache[mf, bf16]

    return get


def _probs(jt, pt, vol):
    """Windowed-volume probabilities from both packages' sliding windows."""
    want = jsw.sliding_window_inference(
        jt._apply_eval, jt._variables(), jct.window_ct(jnp.asarray(vol), *WINDOW),
        patch_size=PATCH, overlap=0.5)
    with torch.inference_mode():
        got = sw.sliding_window_inference(
            pt.unet, ct.window_ct(torch.from_numpy(vol), *WINDOW), patch_size=PATCH, overlap=0.5)
    return got.numpy()[..., 0], np.asarray(want)[..., 0]


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("mf", [2, 1])
def test_segment_volume_matches_jax(trainers, mf, bf16):
    jt, pt = trainers(mf, bf16)
    vol, _ = _volume(0)
    got_p, want_p = _probs(jt, pt, vol)
    assert want_p.std() > 1e-3
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=2e-2 if bf16 else 1e-5)

    want = jt.segment_volume(vol, window=WINDOW)
    got = pt.segment_volume(vol, window=WINDOW)
    assert got.shape == vol.shape and got.dtype == np.uint8
    assert set(np.unique(got)) <= {0, 255}
    assert 0.0 < np.mean(want == 255) < 1.0  # a real mask, not a constant
    assert np.mean(got == want) >= (0.99 if bf16 else 0.999)
    np.testing.assert_array_equal(pt.segement_volume(vol, window=WINDOW), got)
    windowed = ct.window_ct(torch.from_numpy(vol), *WINDOW).numpy()
    np.testing.assert_array_equal(pt.predict_volume(windowed) * 255, got)


def test_segment_volumes_pipelined_matches_single(trainers, tmp_path):
    _, pt = trainers(2, True)
    vols = [_volume(s)[0] for s in (1, 2, 3)]
    singles = [pt.segment_volume(v, window=WINDOW) for v in vols]
    fns = [None, str(tmp_path / "b.nii.gz"), None]
    outs = pt.segment_volumes(iter(vols), save_fns=fns, window=WINDOW, return_preds=True)
    assert len(outs) == 3
    for a, b in zip(singles, outs):
        np.testing.assert_array_equal(a, b)
    data, _, _ = nifti.load(fns[1])
    np.testing.assert_array_equal(data, outs[1])


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


@pytest.mark.parametrize("mf", [2, 1])
def test_evaluate_matches_jax(trainers, mf, tmp_path):
    """Counts equal, Dice/IoU within 1e-6 of the JAX package's DataFrame and
    its CSV, which the port writes in the same layout; one volume has no
    bleed (label 0)."""
    jt, pt = trainers(mf)
    vols, masks = [], []
    for s in (4, 5, 6):
        vol, mask = _volume(s)
        vols.append(np.asarray(jct.window_ct(jnp.asarray(vol), *WINDOW)))
        masks.append(mask)
    masks[2] = np.zeros_like(masks[2])
    ids = np.asarray([7, 3, 11])
    df = jt.evaluate(JaxVolumeDataset3D(vols, masks, ids), save_path=str(tmp_path / "jax"))
    rows = pt.evaluate(VolumeDataset3D(vols, masks, ids), save_path=str(tmp_path / "port"))

    np.testing.assert_array_equal(rows["volID"], df.volID.values)
    np.testing.assert_array_equal(rows["label"], [1, 1, 0])
    np.testing.assert_array_equal(rows["label"], df.label.values)
    for col in ("TP", "TN", "FP", "FN"):
        np.testing.assert_array_equal(rows[col], df[col].values)
    for col in ("Dice", "IoU"):
        np.testing.assert_allclose(rows[col], df[col].values, rtol=0, atol=1e-6)
    for key in ("dice", "iou"):
        for part in ("all", "positive"):
            assert abs(pt.outputs["eval"][key][part] - jt.outputs["eval"][key][part]) <= 1e-6
    assert pt.outputs["eval"]["time"] > 0

    jhead, jrows = _read_csv(tmp_path / "jax" / "volume_prediction_scores.csv")
    phead, prows = _read_csv(tmp_path / "port" / "volume_prediction_scores.csv")
    assert phead == jhead == ["", "volID", "label", "TP", "TN", "FP", "FN", "Dice", "IoU"]
    assert len(prows) == len(jrows) == 3
    for p, j in zip(prows, jrows):
        assert p[:7] == j[:7]  # index, volID, label and counts, as text
        np.testing.assert_allclose([float(x) for x in p[7:]], [float(x) for x in j[7:]],
                                   rtol=0, atol=1e-6)


def test_serve_3d_once_matches_unet3d(trainers, tmp_path):
    """``serve --mode 3d --once`` reads (H, W, D) NIfTIs, segments the
    (D, H, W) transposes with the bf16 GroupNorm net and writes (H, W, D)
    masks with the volume's affine: equal to the port's UNet3D, and within
    the bf16 tolerance of the JAX package's."""
    jt, pt = trainers(2, True)
    watch, out = tmp_path / "watch", tmp_path / "out"
    os.makedirs(watch)
    affine = np.diag([0.5, 0.5, 5.0, 1.0])
    vols = {}
    for i in (1, 2):
        vol, _ = synthetic_ich_volume(size=32, depth=20, seed=20 + i)
        vols[f"{i:03}"] = vol
        nifti.save(str(watch / f"{i:03}.nii.gz"), vol, affine)
    model_fn = str(tmp_path / "m3d.pt")
    pt.save_model(model_fn)

    serve.main(["--watch-dir", str(watch), "-o", str(out), "-m", model_fn, "--mode", "3d",
                "--depth", "3", "--top-filter", "8", "--patch", "16", "--once",
                "--device", "cpu"])
    for name, vol in vols.items():
        mask, aff, _ = nifti.load(str(out / f"{name}_mask.nii.gz"))
        assert mask.shape == vol.shape and mask.dtype == np.uint8
        np.testing.assert_allclose(aff, affine)
        dhw = np.transpose(vol, (2, 0, 1))
        np.testing.assert_array_equal(np.transpose(mask, (2, 0, 1)),
                                      pt.segment_volume(dhw, window=WINDOW))
        want = jt.segment_volume(dhw, window=WINDOW)
        assert np.mean(np.transpose(mask, (2, 0, 1)) == want) >= 0.99
        assert (out / f"{name}.done").exists()
    assert not [f for f in os.listdir(out) if f.startswith(".")]  # no temp left


def test_load_segich_3d_matches_jax(tmp_path):
    """NIfTIs with spacing (0.5, 0.5, 5.0) resampled to (-1, -1, 2.5): the
    image by order-1 zoom with its range kept, the mask by nearest zoom.
    Masks equal, images within 1e-5."""
    affine = np.diag([0.5, 0.5, 5.0, 1.0])
    for pid, seed in ((1, 30), (4, 31)):
        vol, mask = synthetic_ich_volume(size=24, depth=7, seed=seed)
        nifti.save(str(tmp_path / "ct_scans" / f"{pid:03}.nii"), vol.astype(np.int16), affine)
        nifti.save(str(tmp_path / "masks" / f"{pid:03}.nii"), mask.astype(np.uint8), affine)
    want = jax_load_segich_3d(str(tmp_path), [1, 4])
    got = load_segich_3d(str(tmp_path), [1, 4])
    np.testing.assert_array_equal(got.vol_ids, want.vol_ids)
    for gv, gm, wv, wm in zip(got.volumes, got.masks, want.volumes, want.masks):
        assert gv.shape == wv.shape == (14, 24, 24)
        assert gm.max() > 0
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5)
