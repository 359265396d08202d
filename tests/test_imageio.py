"""The standard-library PNG codec: round trips, Pillow's files, and the
committed goldens."""

import io
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from arkoserenderer.utils import imageio

GOLDENS = sorted((Path(__file__).parent / "goldens").glob("*.png"))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trip(rng, channels, tmp_path):
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = (rng.random(shape) * 255).astype(np.uint8)
    path = tmp_path / "a.png"
    imageio.save_png(str(path), img)
    back = imageio.decode_png(path.read_bytes())
    np.testing.assert_array_equal(back.reshape(img.shape), img)
    # Pillow reads what we write.
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_float_frames_are_quantized_like_to_u8(rng):
    img = rng.random((8, 8, 3)).astype(np.float32)
    back = imageio.decode_png(imageio.encode_png(img))
    np.testing.assert_array_equal(back, imageio.to_u8(img))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_reads_pillow_pngs_with_every_filter(rng, mode):
    # Smooth content makes Pillow's adaptive filtering pick Sub, Up,
    # Average and Paeth rows.
    c = len(mode)
    y, x = np.mgrid[0:40, 0:60]
    img = ((x[..., None] * 3 + y[..., None] * 5 + np.arange(c) * 40
            + rng.integers(0, 3, (40, 60, c))) % 256).astype(np.uint8)
    img = img[..., 0] if c == 1 else img
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG", optimize=True)
    back = imageio.decode_png(buf.getvalue())
    np.testing.assert_array_equal(back.reshape(img.shape), img)


@pytest.mark.parametrize("path", GOLDENS, ids=lambda p: p.stem)
def test_reads_the_committed_goldens(path):
    ours = imageio.load_image_rgba(str(path))
    with Image.open(path) as im:
        np.testing.assert_array_equal(ours, np.asarray(im.convert("RGBA")))
    # And writes them back losslessly.
    again = imageio.decode_png(imageio.encode_png(ours[..., :3]))
    np.testing.assert_array_equal(again, ours[..., :3])


def test_sixteen_bit_and_palette_pngs(rng):
    i16 = (rng.random((10, 12)) * 65535).astype(np.uint16)
    buf = io.BytesIO()
    Image.fromarray(i16).save(buf, format="PNG")
    back = imageio.decode_png(buf.getvalue())
    np.testing.assert_array_equal(back[..., 0], (i16 >> 8).astype(np.uint8))
    rgb = (rng.random((10, 12, 3)) * 255).astype(np.uint8)
    pal = Image.fromarray(rgb).quantize(256)
    buf = io.BytesIO()
    pal.save(buf, format="PNG")
    np.testing.assert_array_equal(imageio.decode_png(buf.getvalue()),
                                  np.asarray(pal.convert("RGB")))


def test_rejects_what_is_not_a_png():
    with pytest.raises(ValueError, match="not a PNG"):
        imageio.decode_png(b"GIF89a" + bytes(20))
