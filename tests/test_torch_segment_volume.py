"""The port's 2.5D serving path (UNet2D.segment_volume(s) and
``python -m ich_tpu_torch.serve``) against the JAX package's, with carried
weights, on the CPU."""

import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ich_tpu.data import synthetic_ich_volume
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.train.segmentation2d import UNet2D as JaxUNet2D
from ich_tpu_torch import serve
from ich_tpu_torch.data import nifti
from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.train.segmentation2d import UNet2D

torch.set_num_threads(2)

NET = dict(depth=3, top_filter=8, p_dropout=0.0)
KW = dict(window=(50.0, 200.0), input_size=(32, 32))


@pytest.fixture(scope="module")
def pair():
    """A JAX trainer and a port trainer holding the same weights, with
    non-trivial BatchNorm running statistics."""
    rng = np.random.default_rng(0)
    jt = JaxUNet2D(JaxUNet(**NET), batch_size=4)
    jt._ensure_state((32, 32))
    v = jax.tree_util.tree_map(np.asarray, jt._variables())

    def stat(path, a):
        if "mean" in jax.tree_util.keystr(path):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(stat, v["batch_stats"])
    jt.state = jt.state.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    net = UNet(**NET)
    sd = unet_state_dict_from_jax({"params": v["params"], "batch_stats": stats})
    net.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    return jt, UNet2D(net, batch_size=4, device="cpu")


VOLUMES = {
    "square": lambda: synthetic_ich_volume(size=32, depth=20, seed=2)[0],
    "non_square_ragged_z": lambda: np.random.default_rng(3).uniform(
        -50, 150, size=(48, 40, 7)).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_segment_volume_matches_jax(pair, name):
    jt, pt = pair
    vol = VOLUMES[name]()
    want = jt.segment_volume(vol, return_pred=True, **KW)
    got = pt.segment_volume(vol, return_pred=True, **KW)
    assert got.shape == vol.shape and got.dtype == np.uint8
    assert set(np.unique(got)) <= {0, 255}
    assert 0.0 < np.mean(want == 255) < 1.0  # a real mask, not a constant
    # only threshold flips at p ~ 0.5 may differ
    assert np.mean(got == want) >= 0.999


def test_segment_volumes_pipelined_matches_single(pair, tmp_path):
    _, pt = pair
    vols = [synthetic_ich_volume(size=32, depth=9, seed=s)[0] for s in (4, 5, 6)]
    singles = [pt.segment_volume(v, return_pred=True, **KW) for v in vols]
    fns = [None, str(tmp_path / "b.nii.gz"), None]
    outs = pt.segment_volumes(iter(vols), save_fns=fns, return_preds=True,
                              pipeline_depth=2, **KW)
    for a, b in zip(singles, outs):
        np.testing.assert_array_equal(a, b)
    data, _, _ = nifti.load(fns[1])
    np.testing.assert_array_equal(data, outs[1])


def test_save_load_model(pair, tmp_path):
    _, pt = pair
    fn = str(tmp_path / "m.pt")
    pt.save_model(fn)
    other = UNet2D(UNet(**NET), batch_size=4, device="cpu")
    other.load_model(fn)
    for k, t in pt.get_state_dict().items():
        assert torch.equal(other.get_state_dict()[k], t)


def _serve_args(watch, out, model_fn, *extra):
    return ["--watch-dir", str(watch), "-o", str(out), "-m", model_fn, "--depth", "3",
            "--top-filter", "8", "--size", "32", "--once", "--device", "cpu", *extra]


def test_serve_once_writes_masks_and_done_markers(pair, tmp_path, capsys):
    _, pt = pair
    watch, out = tmp_path / "watch", tmp_path / "out"
    os.makedirs(watch)
    vols = {f"{i:03}": synthetic_ich_volume(size=32, depth=6, seed=10 + i)[0] for i in (1, 2)}
    for name, vol in vols.items():
        nifti.save(str(watch / f"{name}.nii.gz"), vol)
    model_fn = str(tmp_path / "m.pt")
    pt.save_model(model_fn)

    serve.main(_serve_args(watch, out, model_fn))
    for name, vol in vols.items():
        mask, _, _ = nifti.load(str(out / f"{name}_mask.nii.gz"))
        np.testing.assert_array_equal(mask, pt.segment_volume(vol, return_pred=True, **KW))
        assert (out / f"{name}.done").exists()
    assert not [f for f in os.listdir(out) if f.startswith(".")]  # no temp left
    # restart with everything done: serves nothing
    capsys.readouterr()
    serve.main(_serve_args(watch, out, model_fn))
    assert "_mask.nii.gz" not in capsys.readouterr().out


def test_serve_quarantines_corrupt_file(pair, tmp_path):
    _, pt = pair
    watch, out = tmp_path / "watch", tmp_path / "out"
    os.makedirs(watch)
    nifti.save(str(watch / "001.nii"), synthetic_ich_volume(size=32, depth=4, seed=1)[0])
    with open(watch / "corrupt.nii.gz", "wb") as f:
        f.write(b"\x1f\x8b not a real gzip stream")
    model_fn = str(tmp_path / "m.pt")
    pt.save_model(model_fn)

    serve.main(_serve_args(watch, out, model_fn))
    assert (out / "001.done").exists()
    assert (out / "corrupt.retries").exists() and not (out / "corrupt.failed").exists()
    for _ in range(serve.MAX_RETRIES):
        serve.main(_serve_args(watch, out, model_fn))
        if (out / "corrupt.failed").exists():
            break
    assert (out / "corrupt.failed").exists()
    assert not (out / "corrupt.retries").exists()
    assert serve._pending(str(watch), str(out)) == []


def test_serve_vol_name_and_mask_outputs_not_reingested(tmp_path):
    assert serve._vol_name("/in/scan.nii.gz") == "scan"
    assert serve._vol_name("a.nii_v2.nii.gz") == "a.nii_v2"
    for fn in ("a.nii", "a_mask.nii.gz", ".a_mask.tmp.nii.gz", "notes.txt"):
        (tmp_path / fn).write_bytes(b"")
    assert serve._pending(str(tmp_path), str(tmp_path)) == [str(tmp_path / "a.nii")]


def test_serve_refuses_3d_and_missing_card(pair, tmp_path):
    _, pt = pair
    model_fn = str(tmp_path / "m.pt")
    pt.save_model(model_fn)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(_serve_args(tmp_path, tmp_path / "o", model_fn, "--mode", "3d"))
    if not torch.cuda.is_available():  # never a silent switch to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(_serve_args(tmp_path, tmp_path / "o", model_fn, "--device", "cuda"))
        with pytest.raises(RuntimeError):
            UNet2D(UNet(**NET))
