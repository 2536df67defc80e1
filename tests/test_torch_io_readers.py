"""The SegICH 2D CSV path without pandas or PIL: the numpy TIFF and BMP
readers against PIL (PIL-written files read equal to the arrays written;
port-written files read back equal by PIL), the port's SegICH tree writer
against the JAX package's (CSV bytes equal, images equal), the JAX loader
on a port-written tree against the port's loader, the CSV table against
pandas' ``read_csv(index_col=0)``, and ``subsample_negatives`` against the
JAX one (pandas' ``sample``)."""

import filecmp
import os

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from ich_tpu.data import segich as jax_segich
from ich_tpu.data.synthetic import write_segich_tree as jax_write_segich_tree
from ich_tpu_torch.data import segich, table
from ich_tpu_torch.data.bmp import read_bmp, save_bmp_gray
from ich_tpu_torch.data.synthetic import synthetic_ich_slices, write_segich_tree
from ich_tpu_torch.data.tiff import read_tiff, write_tiff

SHAPES = [(5, 7), (3, 10), (33, 18)]  # widths not a multiple of 4
MODES = {"F": np.float32, "I": np.int32, "I;16": np.uint16, "L": np.uint8}


def _array(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.normal(size=shape) * 300).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -2**20), min(info.max, 2**20), size=shape, dtype=dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", list(MODES))
def test_tiff_reader_reads_pil_files_and_pil_reads_the_writer(tmp_path, mode, shape):
    a = _array(MODES[mode], shape, sum(shape))
    fn = str(tmp_path / "pil.tif")
    (Image.fromarray(a, mode=mode) if mode != "I;16" else Image.fromarray(a)).save(fn)
    got = read_tiff(fn)
    assert got.dtype == a.dtype and np.array_equal(got, a)
    port = str(tmp_path / "port.tif")
    write_tiff(port, a)
    with Image.open(port) as im:
        assert im.mode == mode
        back = np.asarray(im)
    assert back.dtype == a.dtype and np.array_equal(back, a)
    assert np.array_equal(read_tiff(port), a)


def test_tiff_reader_raises_on_what_it_does_not_read(tmp_path):
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    Image.fromarray(a).save(str(tmp_path / "lzw.tif"), compression="tiff_lzw")
    with pytest.raises(ValueError, match="compress"):
        read_tiff(str(tmp_path / "lzw.tif"))
    Image.fromarray(np.zeros((3, 4, 3), np.uint8)).save(str(tmp_path / "rgb.tif"))
    with pytest.raises(ValueError, match="samples per pixel"):
        read_tiff(str(tmp_path / "rgb.tif"))
    big = bytearray(open(str(tmp_path / "rgb.tif"), "rb").read())
    big[:4] = b"MM\x00*"
    (tmp_path / "be.tif").write_bytes(bytes(big))
    with pytest.raises(ValueError, match="little-endian"):
        read_tiff(str(tmp_path / "be.tif"))
    with pytest.raises(ValueError):
        write_tiff(str(tmp_path / "x.tif"), np.zeros((2, 2), np.float64))


@pytest.mark.parametrize("shape", SHAPES)
def test_bmp_reader_reads_pil_gray_and_rgb(tmp_path, shape):
    rng = np.random.default_rng(sum(shape))
    gray = rng.integers(0, 256, shape, dtype=np.uint8)
    rgb = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    for a in (gray, rgb):
        fn = str(tmp_path / "pil.bmp")
        Image.fromarray(a).save(fn)
        got = read_bmp(fn)
        assert got.dtype == np.uint8 and np.array_equal(got, np.asarray(Image.open(fn)))
        assert np.array_equal(got, a)
    save_bmp_gray(str(tmp_path / "port.bmp"), gray)
    assert np.array_equal(read_bmp(str(tmp_path / "port.bmp")), gray)
    Image.fromarray(gray > 127).save(str(tmp_path / "one_bit.bmp"))
    with pytest.raises(ValueError, match="1-bit"):
        read_bmp(str(tmp_path / "one_bit.bmp"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same slices written by the port's writer and by the JAX
    package's (pandas, PIL): 5 patients of 40^2, some negative slices."""
    root = tmp_path_factory.mktemp("trees")
    ds = synthetic_ich_slices(n_slices=30, size=40, n_volumes=5, seed=7, positive_frac=0.5)
    write_segich_tree(ds, str(root / "port"))
    jax_write_segich_tree(ds, str(root / "jax"))
    return str(root / "port"), str(root / "jax")


def test_port_tree_equals_the_jax_writers_and_pil_reads_it(trees):
    port, jax = trees
    for name in ("ct_info.csv", "patient_info.csv"):
        assert filecmp.cmp(os.path.join(port, name), os.path.join(jax, name), shallow=False), name
    files = [os.path.relpath(os.path.join(r, f), jax)
             for r, _, fs in os.walk(os.path.join(jax, "Patient_CT")) for f in fs]
    assert any(f.endswith(".bmp") for f in files) and any(f.endswith(".tif") for f in files)
    for rel in files:
        with Image.open(os.path.join(jax, rel)) as a, Image.open(os.path.join(port, rel)) as b:
            assert a.mode == b.mode
            want = np.asarray(a)
            assert np.array_equal(np.asarray(b), want), rel
        assert np.array_equal(segich.read_image(os.path.join(port, rel)), want), rel


def test_jax_loader_reads_the_port_tree_as_the_port_loader(trees):
    port, _ = trees
    got = segich.load_segich_2d(port, window=(50, 200), size=32)
    want = jax_segich.load_segich_2d(port, window=(50, 200), size=32)
    np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(got.vol_ids, want.vol_ids)
    np.testing.assert_array_equal(got.slice_nbrs, want.slice_nbrs)
    assert got.masks.sum() > 0


def test_csv_table_reads_as_pandas(tmp_path, trees):
    port, _ = trees
    for name in ("ct_info.csv", "patient_info.csv"):
        t = table.read_csv(os.path.join(port, name))
        df = pd.read_csv(os.path.join(port, name), index_col=0)
        np.testing.assert_array_equal(t.index, df.index.values)
        assert list(t.columns) == list(df.columns)
        for c in df.columns:
            want = df[c].to_numpy()
            if want.dtype.kind in "if":
                assert t[c].dtype == want.dtype, c
                np.testing.assert_array_equal(t[c], want)
            else:
                assert [v if isinstance(v, str) else "NaN" for v in t[c]] == \
                    [v if isinstance(v, str) else "NaN" for v in want], c
    fn = str(tmp_path / "s.csv")
    with open(fn, "w") as f:
        f.write(",PatientNumber,mask_fn,x\n0,1,,1.5\n1,2,None,\n2,3,nan,2\n3,4,-,3\n4,5,a.bmp,4\n")
    t = table.read_csv(fn)
    df = pd.read_csv(fn, index_col=0)
    assert [isinstance(v, str) for v in t["mask_fn"]] == [isinstance(v, str) for v in df.mask_fn]
    assert list(t["mask_fn"][3:]) == ["-", "a.bmp"]
    np.testing.assert_array_equal(t["x"], df.x.to_numpy())
    assert t["PatientNumber"].dtype == np.int64
    rows = t.to_dict("records")
    assert rows[4] == {"PatientNumber": 5, "mask_fn": "a.bmp", "x": 4.0}
    np.testing.assert_array_equal(table.unique_in_order([3, 1, 3, 2, 1]), [3, 1, 2])


@pytest.mark.parametrize("frac_negative,seed", [(0.5, 0), (0.25, 3), (1.0, 42), (2.0, 42),
                                                (0.0, 7)])
def test_subsample_negatives_keeps_pandas_rows(trees, frac_negative, seed):
    """The rows pandas' ``sample`` removes, on a Table and on a DataFrame
    (a DataFrame given, a DataFrame returned), in the file's order; the
    split summary's text equal."""
    port, _ = trees
    df = pd.read_csv(os.path.join(port, "ct_info.csv"), index_col=0)
    t = table.read_csv(os.path.join(port, "ct_info.csv"))
    want = jax_segich.subsample_negatives(df, frac_negative, seed)
    pd.testing.assert_frame_equal(segich.subsample_negatives(df, frac_negative, seed), want)
    got = segich.subsample_negatives(t, frac_negative, seed)
    np.testing.assert_array_equal(got.index, want.index.values)
    assert list(got.index) == sorted(got.index)
    assert segich.split_summary_table(t, got, t) == jax_segich.split_summary_table(df, want, df)
