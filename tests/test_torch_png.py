"""The port's grayscale PNG writer and reader (ich_tpu_torch.data.png)
against PIL: every file the writer makes decodes in PIL to the same pixels,
and the reader reads PIL's own files (whatever row filters PIL picks)
exactly."""

import numpy as np
import pytest

Image = pytest.importorskip("PIL.Image")

from ich_tpu_torch.data.png import read_png_gray, save_png_gray  # noqa: E402

SHAPES = [(1, 1), (7, 13), (32, 96), (256, 768)]


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=shape).astype(np.uint8)
    img[: shape[0] // 2] = np.linspace(0, 255, shape[1]).astype(np.uint8)  # smooth rows
    return img


@pytest.mark.parametrize("shape", SHAPES)
def test_writer_pixels_equal_pil_decode(tmp_path, shape):
    img = _image(shape, sum(shape))
    fn = str(tmp_path / "a.png")
    save_png_gray(fn, img)
    with Image.open(fn) as im:
        assert im.mode == "L" and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(read_png_gray(fn), img)


@pytest.mark.parametrize("shape", SHAPES)
def test_reader_reads_pil_files(tmp_path, shape):
    img = _image(shape, 3 * sum(shape))
    fn = str(tmp_path / "b.png")
    Image.fromarray(img).save(fn, optimize=True)
    np.testing.assert_array_equal(read_png_gray(fn), img)


def test_writer_rejects_other_arrays(tmp_path):
    with pytest.raises(ValueError):
        save_png_gray(str(tmp_path / "c.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        save_png_gray(str(tmp_path / "c.png"), np.zeros((4, 4, 3), np.uint8))
