"""The port's figure CLI (``ich_tpu_torch.experiments.figures``) against
``scripts/figures.py`` (run with click's ``CliRunner``), on the CPU: each
command's arrays equal those the JAX script computes with pandas and PIL,
each command draws the JAX script's artists (line, bar, scatter and image
data equal) and writes its file; the GIFs are the same bytes."""

import os
import sys

import matplotlib

matplotlib.use("Agg")
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
from click.testing import CliRunner  # noqa: E402
from PIL import Image  # noqa: E402

from ich_tpu.data import nifti as jax_nifti  # noqa: E402
from ich_tpu.ops.ct import window_ct as jax_window_ct  # noqa: E402
from ich_tpu_torch.data import nifti, synthetic  # noqa: E402
from ich_tpu_torch.data.datasets import write_rsna_slice_info  # noqa: E402
from ich_tpu_torch.experiments import data_preparation, figures  # noqa: E402

from _mpl_artists import _assert_same_artists, drawn  # noqa: E402,F401

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _jax_cli(args):
    sys.path.insert(0, SCRIPTS)
    try:
        import figures as jax_figures
    finally:
        sys.path.remove(SCRIPTS)
    r = CliRunner().invoke(jax_figures.cli, args)
    assert r.exit_code == 0, r.output
    return r.output


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A NIfTI dataset (anisotropic, 0.5 × 0.5 × 5 mm), its SegICH 2D tree
    from ``gen-2d-seg`` with demographics, the SegICH tree of the
    synthetic writer (Age and Gender of its own) and an RSNA
    ``slice_info.csv``."""
    root = tmp_path_factory.mktemp("figs")
    for sub in ("ct_scans", "masks"):
        os.makedirs(root / "nifti" / sub)
    for pid in (1, 2, 3):
        vol, mask = synthetic.synthetic_ich_volume(size=32, depth=8, seed=pid)
        nifti.save(str(root / "nifti" / "ct_scans" / f"{pid:03}.nii"), vol,
                   np.diag([0.5, 0.5, 5.0, 1.0]))
        nifti.save(str(root / "nifti" / "masks" / f"{pid:03}.nii"), mask.astype(np.uint8))
    demo = root / "demo.csv"
    demo.write_text('Patient Number,Age,Gender,x\n,,,y\n1,41,Male,0\n3,67,Female,1\n'
                    '2,55,Male,0\nTotal,,,1\n,,,\n')
    data_preparation.main(["gen-2d-seg", "--data-dir", str(root / "nifti"), "--out-dir",
                           str(root / "seg2d"), "--demographics-csv", str(demo)])
    seg = synthetic.write_segich_tree(
        synthetic.synthetic_ich_slices(n_slices=12, size=32, n_volumes=3, seed=4),
        str(root / "segich"))
    label_csv = synthetic.write_rsna_tree(str(root / "rsna"), n_slices=40, size=8, seed=1)
    write_rsna_slice_info(label_csv, str(root / "slice_info.csv"))
    return root, str(root / "seg2d"), seg


@pytest.mark.parametrize("tree", ["seg2d", "segich"])
def test_dataset_stats_equals_jax(trees, tmp_path, drawn, tree):
    data_dir = trees[1] if tree == "seg2d" else trees[2]
    df = pd.read_csv(os.path.join(data_dir, "ct_info.csv"), index_col=0)
    a = figures.dataset_stats_arrays(data_dir)
    np.testing.assert_array_equal(a["slices_per_patient"],
                                  df.groupby("PatientNumber").size().values)
    np.testing.assert_array_equal(a["positive_fraction"],
                                  df.groupby("PatientNumber").Hemorrhage.mean().values)
    counts = df.Hemorrhage.value_counts()
    assert a["label_counts"].tolist() == [counts.get(0, 0), counts.get(1, 0)]
    _jax_cli(["dataset-stats", "--data-dir", data_dir, "--out-fn", str(tmp_path / "j.pdf")])
    figures.main(["dataset-stats", "--data-dir", data_dir, "--out-fn", str(tmp_path / "p.pdf")])
    assert len(drawn) == 2 and os.path.getsize(tmp_path / "p.pdf") > 2000
    _assert_same_artists(drawn[1], drawn[0])


@pytest.mark.parametrize("tree", ["seg2d", "segich"])
def test_explore_equals_jax(trees, tmp_path, drawn, tree):
    data_dir = trees[1] if tree == "seg2d" else trees[2]
    patients = pd.read_csv(os.path.join(data_dir, "patient_info.csv"), index_col=0)
    meta = figures.metadata_arrays(data_dir)
    np.testing.assert_array_equal(meta["age"], patients["Age"].values)
    counts = patients.Gender.value_counts()
    assert meta["gender"] == list(counts.index)
    np.testing.assert_array_equal(meta["gender_counts"], counts.values)
    pid = int(patients.PatientNumber.iloc[-1])
    args = ["explore", "--data-dir", data_dir, "--gif-patient", str(pid), "--fps", "3"]
    _jax_cli(args + ["--out-dir", str(tmp_path / "j")])
    figures.main(args + ["--out-dir", str(tmp_path / "p")])
    # the metadata page (the GIF's frames are drawn, not saved, and held by bytes)
    assert len(drawn) == 2
    _assert_same_artists(drawn[1], drawn[0])
    with open(tmp_path / "p" / f"{pid}_CT.gif", "rb") as a, \
            open(tmp_path / "j" / f"{pid}_CT.gif", "rb") as b:
        assert a.read() == b.read()
    assert os.path.getsize(tmp_path / "p" / "metadata_stat.pdf") > 2000


def test_gif_frames_equal_jax(trees):
    _, data_dir, _ = trees
    df = pd.read_csv(os.path.join(data_dir, "ct_info.csv"), index_col=0)
    rows = df[df.PatientNumber == 2].sort_values("SliceNumber")
    imgs, masks = figures.gif_frames(data_dir, 2)
    assert len(imgs) == len(rows) == 8 and any(m.any() for m in masks)
    for (_, r), im, m in zip(rows.iterrows(), imgs, masks):
        want = np.asarray(Image.open(os.path.join(data_dir, r.CT_fn)), np.float32)
        want = (want - want.min()) / max(want.max() - want.min(), 1e-6)
        np.testing.assert_array_equal(im, want)
        want_m = (np.asarray(Image.open(os.path.join(data_dir, r.mask_fn))) > 0
                  if r.mask_fn != "-" else np.zeros(want.shape, bool))
        np.testing.assert_array_equal(m, want_m.astype(np.float32))
    with pytest.raises(ValueError, match="no slices"):
        figures.gif_frames(data_dir, 99)


def test_explore_without_metadata_still_writes_the_gif(trees, tmp_path):
    root, _, _ = trees
    out = tmp_path / "seg"
    data_preparation.main(["gen-2d-seg", "--data-dir", str(root / "nifti"), "--out-dir",
                           str(out)])
    assert figures.metadata_arrays(str(out)) is None
    figures.main(["explore", "--data-dir", str(out), "--out-dir", str(tmp_path / "o"),
                  "--gif-patient", "1"])
    assert os.path.exists(tmp_path / "o" / "1_CT.gif")
    assert not os.path.exists(tmp_path / "o" / "metadata_stat.pdf")


def test_rsna_stats_equals_jax(trees, tmp_path, drawn):
    root, _, _ = trees
    csv_path = str(root / "slice_info.csv")
    df = pd.read_csv(csv_path, index_col=0)
    a = figures.rsna_stats_arrays(csv_path)
    assert a["n_pos"] == int(df.Hemorrhage.sum()) > 0
    assert a["n_neg"] == len(df) - a["n_pos"] > 0
    assert a["subtypes"] == [s for s in figures.RSNA_SUBTYPES if s in df.columns]
    np.testing.assert_array_equal(a["counts"], df[a["subtypes"]].sum(axis=0).values)
    _jax_cli(["rsna-stats", "--csv-path", csv_path, "--out-fn", str(tmp_path / "j.pdf")])
    figures.main(["rsna-stats", "--csv-path", csv_path, "--out-fn", str(tmp_path / "p.pdf")])
    assert len(drawn) == 2 and os.path.getsize(tmp_path / "p.pdf") > 2000
    _assert_same_artists(drawn[1], drawn[0])


@pytest.mark.parametrize("mode,with_mask", [("montage", True), ("montage", False),
                                            ("3d", True), ("3d", False)])
def test_view_volume_equals_jax(trees, tmp_path, drawn, mode, with_mask):
    root, _, _ = trees
    vol_fn = str(root / "nifti" / "ct_scans" / "002.nii")
    mask_fn = str(root / "nifti" / "masks" / "002.nii") if with_mask else None
    vol, mask, affine = figures.load_windowed(vol_fn, mask_fn, (40.0, 120.0), "cpu")
    jvol, jaff, _ = jax_nifti.load(vol_fn)
    want = np.asarray(jax_window_ct(jvol.astype(np.float32), 40.0, 120.0))
    np.testing.assert_allclose(vol, want, rtol=0, atol=1e-6)
    if mode == "3d":
        spacing = np.abs(np.asarray(jaff)[:3, :3]).max(axis=0)
        views = figures.mip_views(vol, mask, affine)
        assert [v[3] for v in views] == [spacing[0] / spacing[1], spacing[2] / spacing[0],
                                         spacing[2] / spacing[1]] == [1.0, 10.0, 10.0]
        np.testing.assert_array_equal(views[1][1], vol.max(axis=1).T[::-1])
    else:
        m = figures.montage_arrays(vol, mask, 6)
        np.testing.assert_array_equal(m["z"], np.linspace(0, 7, 6).astype(int))
    args = ["view-volume", vol_fn, "--mode", mode, "--n-slices", "6", "--win-center", "40",
            "--win-width", "120"] + (["--mask-path", mask_fn] if with_mask else [])
    _jax_cli(args + ["--out-fn", str(tmp_path / "j.png")])
    figures.main(args + ["--out-fn", str(tmp_path / "p.png"), "--device", "cpu"])
    assert len(drawn) == 2 and os.path.getsize(tmp_path / "p.png") > 2000
    got, want = drawn[1], drawn[0]
    # the windowed images within float32 rounding (torch against XLA), the
    # rest equal
    for g, w in zip(got, want):
        for a, b in zip(g.pop("images"), w.pop("images")):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    _assert_same_artists(got, want)
