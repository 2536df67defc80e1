"""The port's RSNA data path against the JAX package's: the label pivot
against ``scripts/data_preparation.py gen-rsna-csv`` (run with click's
``CliRunner``), ``load_rsna_slices`` (images within 1e-6, labels equal),
and the synthetic RSNA slices and on-disk tree (equal arrays and files)."""

import csv
import filecmp
import os
import sys

import numpy as np
import pytest
from click.testing import CliRunner

from ich_tpu.data import datasets as jax_datasets
from ich_tpu.data import synthetic as jax_synthetic
from ich_tpu_torch.data import datasets, synthetic

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def _gen_rsna_csv(label_csv, out_csv):
    sys.path.insert(0, SCRIPTS)
    try:
        import data_preparation
    finally:
        sys.path.remove(SCRIPTS)
    r = CliRunner().invoke(data_preparation.cli,
                           ["gen-rsna-csv", "--label-csv", label_csv, "--out-csv", out_csv])
    assert r.exit_code == 0, r.output


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same RSNA tree written by both packages."""
    root = tmp_path_factory.mktemp("rsna")
    port = synthetic.write_rsna_tree(str(root / "port"), n_slices=9, size=40, seed=3)
    jax_csv = jax_synthetic.write_rsna_tree(str(root / "jax"), n_slices=9, size=40, seed=3)
    return root, port, jax_csv


def test_write_rsna_tree_equals_jax(trees):
    root, port, jax_csv = trees
    assert filecmp.cmp(port, jax_csv, shallow=False)
    names = sorted(os.listdir(root / "jax" / "stage_2_train"))
    assert sorted(os.listdir(root / "port" / "stage_2_train")) == names and len(names) == 9
    for n in names:
        assert filecmp.cmp(root / "port" / "stage_2_train" / n, root / "jax" / "stage_2_train" / n,
                           shallow=False), n


@pytest.mark.parametrize("holes", [False, True])
def test_slice_info_pivot_equals_gen_rsna_csv(trees, tmp_path, holes):
    """Same text: rows in the same order with the same index, columns and
    values. With ``holes`` a few label rows are removed, so pandas turns
    every label into a float and leaves the missing cells empty."""
    _, label_csv, _ = trees
    if holes:
        rows = _rows(label_csv)
        kept = [r for i, r in enumerate(rows) if i == 0 or i % 11 != 5]
        label_csv = str(tmp_path / "holes.csv")
        with open(label_csv, "w", newline="") as f:
            csv.writer(f).writerows(kept)
    want, got = str(tmp_path / "want.csv"), str(tmp_path / "got.csv")
    _gen_rsna_csv(label_csv, want)
    n = datasets.write_rsna_slice_info(label_csv, got)
    assert _rows(got) == _rows(want)
    assert n == 9 == len(_rows(got)) - 1
    assert not any(r[-2] == datasets.RSNA_CORRUPT_FILE for r in _rows(got))
    if holes:
        assert any(c == "" for r in _rows(got) for c in r) and "1.0" in _rows(got)[1] + _rows(got)[2]


def test_pivot_without_any_rows(tmp_path):
    src = str(tmp_path / "s.csv")
    with open(src, "w", newline="") as f:
        csv.writer(f).writerows([["ID", "Label"], ["ID_b_epidural", 1], ["ID_a_epidural", 0],
                                 ["ID_a_subdural", 1], ["ID_b_subdural", 0]])
    want, got = str(tmp_path / "want.csv"), str(tmp_path / "got.csv")
    _gen_rsna_csv(src, want)
    datasets.write_rsna_slice_info(src, got)
    assert _rows(got) == _rows(want)


def test_load_rsna_slices_matches_jax(trees, tmp_path):
    import pandas as pd

    root, label_csv, _ = trees
    dcm_dir = str(root / "port" / "stage_2_train")
    info = os.path.join(dcm_dir, "slice_info.csv")
    datasets.write_rsna_slice_info(label_csv, info)
    want = jax_datasets.load_rsna_slices(dcm_dir, window=(50, 200), size=32, n_max=7)
    got = datasets.load_rsna_slices(dcm_dir, window=(50, 200), size=32, n_max=7)
    assert got.images.shape == want.images.shape == (7, 32, 32)
    np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels[:, 0].sum() > 0 and got.images.std() > 0.05
    # the rows passed in, as a DataFrame or as mappings
    df = pd.read_csv(info, index_col=0)
    for rows in (df, df.to_dict("records")):
        again = datasets.load_rsna_slices(dcm_dir, rows, size=32, n_max=7)
        np.testing.assert_array_equal(again.images, got.images)
        np.testing.assert_array_equal(again.labels, got.labels)


def test_synthetic_rsna_slices_equal_jax():
    want = jax_synthetic.synthetic_rsna_slices(n_slices=24, size=32, seed=5)
    got = synthetic.synthetic_rsna_slices(n_slices=24, size=32, seed=5)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.image_shape == (32, 32) and len(got) == 24
    cached = got.device_cache("cpu")
    assert cached.images.dtype.is_floating_point and np.array_equal(cached.labels, got.labels)
