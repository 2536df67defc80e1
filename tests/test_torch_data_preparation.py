"""The port's dataset preparation CLI (``ich_tpu_torch.experiments.
data_preparation``) against ``scripts/data_preparation.py`` (run with
click's ``CliRunner``) on the same synthetic NIfTIs and DICOMs: CSVs and
BMPs byte-equal, TIFF pixels equal, NIfTI volumes and affines equal; and
the port's ``write_cq500_tree`` and ``synthetic_ich_volume`` against the
JAX package's (equal files and arrays)."""

import csv
import filecmp
import os
import sys

import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image

from ich_tpu.data import nifti as jax_nifti
from ich_tpu.data import synthetic as jax_synthetic
from ich_tpu_torch.data import nifti, synthetic
from ich_tpu_torch.data.segich import load_segich_2d
from ich_tpu_torch.data.tiff import read_tiff
from ich_tpu_torch.experiments import data_preparation as port_cli

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")

# three patients; the names exercise the id parse (001.nii -> 1, 010.nii.gz -> 10)
NAMES = ("001.nii", "002.nii", "010.nii.gz")


def _jax_cli(args):
    sys.path.insert(0, SCRIPTS)
    try:
        import data_preparation
    finally:
        sys.path.remove(SCRIPTS)
    r = CliRunner().invoke(data_preparation.cli, args)
    assert r.exit_code == 0, r.output


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _demographics_csv(path, pids):
    """PhysioNet's ``Patient_demographics.csv`` layout: a title row, a row
    of subtype names under three empty cells, a row per patient, two
    footer rows."""
    lines = ['Patient Number,"Age\n(years)",Gender,Hemorrhage type,,Fracture',
             ",,,Intraventricular,Intraparenchymal,"]
    for i, pid in enumerate(pids):
        lines.append(f"{pid},{30 + 7 * i},{'Male' if i % 2 else 'Female'},0,1,0")
    lines += ["Total,,,1,1,1", "note: ages in years,,,,,"]
    with open(path, "w", newline="") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def nifti_dir(tmp_path_factory):
    """ct_scans/, masks/ and brain_masks/ NIfTIs of three patients; some
    slices without a lesion, the first two of each without brain."""
    d = tmp_path_factory.mktemp("nifti")
    for sub in ("ct_scans", "masks", "brain_masks"):
        os.makedirs(d / sub)
    for seed, name in enumerate(NAMES, start=1):
        vol, mask = synthetic.synthetic_ich_volume(size=32, depth=8, seed=seed)
        nifti.save(str(d / "ct_scans" / name), vol, np.diag([0.5, 0.5, 5.0, 1.0]))
        nifti.save(str(d / "masks" / name), mask.astype(np.uint8))
        brain = (vol > 20).astype(np.uint8)
        brain[:, :, :2] = 0  # slices outside the head
        nifti.save(str(d / "brain_masks" / name), brain)
    return d


def _same_tree(got, want):
    """Every file of ``want`` in ``got`` and nothing more: CSVs and BMPs
    byte-equal, TIFFs pixel-equal."""
    files = sorted(os.path.relpath(os.path.join(r, f), want)
                   for r, _, fs in os.walk(want) for f in fs)
    got_files = sorted(os.path.relpath(os.path.join(r, f), got)
                       for r, _, fs in os.walk(got) for f in fs)
    assert got_files == files
    for rel in files:
        a, b = os.path.join(got, rel), os.path.join(want, rel)
        if rel.endswith(".tif"):
            pa, pb = read_tiff(a), np.asarray(Image.open(b))
            assert pa.dtype == pb.dtype == np.int32, rel
            np.testing.assert_array_equal(pa, pb, err_msg=rel)
        else:
            assert filecmp.cmp(a, b, shallow=False), rel
    return files


@pytest.mark.parametrize("command,extra", [
    ("gen-2d-seg", []),
    ("gen-2d-seg", ["demographics"]),
    ("gen-2d-brain", []),
])
def test_gen_2d_equals_jax_cli(nifti_dir, tmp_path, command, extra):
    args = [command, "--data-dir", str(nifti_dir)]
    if extra:  # patient 2 has no demographics row: Age turns float, Gender empty
        args += ["--demographics-csv",
                 _demographics_csv(str(tmp_path / "demo.csv"), pids=(10, 1, 99))]
    _jax_cli(args + ["--out-dir", str(tmp_path / "jax")])
    port_cli.main(args + ["--out-dir", str(tmp_path / "port")])
    files = _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    n_bmp = sum(f.endswith(".bmp") for f in files)
    assert sum(f.endswith(".tif") for f in files) == 24
    ct = _rows(tmp_path / "port" / "ct_info.csv")
    assert ct[0] == ["", "PatientNumber", "SliceNumber", "CT_fn", "mask_fn", "Hemorrhage"]
    # masks only for positive slices, "-" otherwise
    assert n_bmp == sum(r[5] == "1" for r in ct[1:]) and 0 < n_bmp < 24
    assert all((r[4] == "-") == (r[5] == "0") for r in ct[1:])
    assert sorted({r[1] for r in ct[1:]}) == ["1", "10", "2"]
    patients = _rows(tmp_path / "port" / "patient_info.csv")
    if extra:
        assert patients[0] == ["", "PatientNumber", "Hemorrhage", "Age", "Gender"]
        assert [r[3:] for r in patients[1:]] == [["37.0", "Male"], ["", ""], ["30.0", "Female"]]


def test_gen_2d_seg_tree_loads_as_the_windowed_niftis(nifti_dir, tmp_path):
    """The port's tree read back by the port's loader is the NIfTIs windowed
    (rot90, int32 truncation)."""
    port_cli.main(["gen-2d-seg", "--data-dir", str(nifti_dir), "--out-dir", str(tmp_path)])
    ds = load_segich_2d(str(tmp_path), window=(50, 200), size=32)
    assert len(ds) == 24
    want = []
    for name in sorted(NAMES):
        vol, _, _ = nifti.load(str(nifti_dir / "ct_scans" / name))
        vol = np.rot90(vol, axes=(0, 1)).astype(np.int32).astype(np.float32)
        want.append(np.clip((vol - (50 - 100)) / 200.0, 0, 1).transpose(2, 0, 1))
    np.testing.assert_allclose(np.asarray(ds.images), np.concatenate(want), atol=1e-6)


def test_demographics_with_only_matches_keeps_ints(nifti_dir, tmp_path):
    demo = _demographics_csv(str(tmp_path / "demo.csv"), pids=(2, 10, 1))
    args = ["gen-2d-seg", "--data-dir", str(nifti_dir), "--demographics-csv", demo]
    _jax_cli(args + ["--out-dir", str(tmp_path / "jax")])
    port_cli.main(args + ["--out-dir", str(tmp_path / "port")])
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert [r[3] for r in _rows(tmp_path / "port" / "patient_info.csv")[1:]] == ["44", "30", "37"]


def test_gen_rsna_csv_equals_jax_cli(tmp_path):
    label_csv = synthetic.write_rsna_tree(str(tmp_path / "rsna"), n_slices=9, size=16, seed=2)
    _jax_cli(["gen-rsna-csv", "--label-csv", label_csv, "--out-csv", str(tmp_path / "j.csv")])
    port_cli.main(["gen-rsna-csv", "--label-csv", label_csv,
                   "--out-csv", str(tmp_path / "p.csv")])
    assert filecmp.cmp(tmp_path / "p.csv", tmp_path / "j.csv", shallow=False)
    assert len(_rows(tmp_path / "p.csv")) == 10


@pytest.fixture(scope="module")
def cq500(tmp_path_factory):
    """The same CQ500 root written by both packages."""
    root = tmp_path_factory.mktemp("cq500")
    synthetic.write_cq500_tree(str(root / "port"), n_patients=3, n_slices=5, size=32, seed=7)
    jax_synthetic.write_cq500_tree(str(root / "jax"), n_patients=3, n_slices=5, size=32, seed=7)
    return root


def test_write_cq500_tree_equals_jax(cq500):
    files = sorted(os.path.relpath(os.path.join(r, f), cq500 / "jax")
                   for r, _, fs in os.walk(cq500 / "jax") for f in fs)
    assert len(files) == 3 * 5 + 1
    for rel in files:
        assert filecmp.cmp(cq500 / "port" / rel, cq500 / "jax" / rel, shallow=False), rel


@pytest.mark.parametrize("seed,size,depth", [(0, 64, 32), (5, 40, 7)])
def test_synthetic_ich_volume_equals_jax(seed, size, depth):
    vol, mask = synthetic.synthetic_ich_volume(size=size, depth=depth, seed=seed)
    jvol, jmask = jax_synthetic.synthetic_ich_volume(size=size, depth=depth, seed=seed)
    assert vol.dtype == jvol.dtype and mask.dtype == jmask.dtype
    np.testing.assert_array_equal(vol, jvol)
    np.testing.assert_array_equal(mask, jmask)


def _copy_tree(src, dst):
    import shutil

    shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("layout", ["complete", "series_missing", "probs_missing", "no_probs"])
def test_qure_extract_equals_jax_cli(cq500, tmp_path, layout):
    """``series_missing``: patient 1's series directory is gone, so its row
    comes from ``ICH_probabilities.csv`` alone (index, filename, n_slice
    empty; the index and n_slice turn float). ``probs_missing``: patient 2
    has no probabilities row. ``no_probs``: no probabilities file."""
    root = _copy_tree(cq500 / "port", tmp_path / "root")
    probs = root / "ICH_probabilities.csv"
    if layout == "series_missing":
        import shutil

        shutil.rmtree(root / "1")
    elif layout == "probs_missing":
        rows = _rows(probs)
        with open(probs, "w", newline="") as f:
            f.write("\n".join(",".join(r) for r in rows[:3]) + "\n")
    elif layout == "no_probs":
        os.remove(probs)
    args = ["qure-extract", "--input-path", str(root)]
    _jax_cli(args + ["--out-folder", str(tmp_path / "jax")])
    port_cli.main(args + ["--out-folder", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert filecmp.cmp(tmp_path / "port" / "info.csv", tmp_path / "jax" / "info.csv",
                       shallow=False)
    info = _rows(tmp_path / "port" / "info.csv")
    assert len(info) == 4
    if layout == "series_missing":
        assert info[2][:4] == ["", "1", "", ""] and info[1][0] == "0.0"
    for n in names:
        if n.endswith(".nii"):
            got, gaff, _ = nifti.load(str(tmp_path / "port" / n))
            want, waff, _ = jax_nifti.load(str(tmp_path / "jax" / n))
            assert got.shape == (32, 32, 5)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(gaff, waff)


def test_dicom_to_nifti_equals_jax_cli(cq500, tmp_path):
    series = str(cq500 / "port" / "2")
    _jax_cli(["dicom-to-nifti", "--series-dir", series, "--out-fn", str(tmp_path / "j.nii")])
    port_cli.main(["dicom-to-nifti", "--series-dir", series, "--out-fn", str(tmp_path / "p.nii")])
    assert filecmp.cmp(tmp_path / "p.nii", tmp_path / "j.nii", shallow=False)
    got, aff, _ = nifti.load(str(tmp_path / "p.nii"))
    assert got.shape == (32, 32, 5) and aff[2, 2] == 5.0


def test_cli_rejects_a_missing_input(tmp_path):
    with pytest.raises(SystemExit):
        port_cli.main(["gen-2d-seg", "--data-dir", str(tmp_path / "nope"),
                       "--out-dir", str(tmp_path / "o")])
