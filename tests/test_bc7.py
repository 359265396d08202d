"""BC7 mode-6 codec roundtrip (TextureCompressor BC7 analogue)."""

import numpy as np

from arkoserenderer.assets import bc7


def test_bc7_roundtrip_smooth_gradient():
    x = np.linspace(0, 255, 16)
    img = np.zeros((16, 16, 4), np.uint8)
    img[..., 0] = x[None, :]
    img[..., 1] = x[:, None]
    img[..., 2] = 128
    img[..., 3] = 255
    blocks = bc7.compress_bc7_mode6(img)
    assert blocks.shape == (16, 16)  # 4:1 compression of RGBA8
    out = bc7.decompress_bc7(blocks, 16, 16)
    err = np.abs(out.astype(int) - img.astype(int))
    # R varies horizontally and G vertically inside each block — a 2D color
    # spread one endpoint segment cannot represent exactly; the residual is
    # perpendicular distance to the block diagonal.
    assert err.max() <= 40 and err.mean() < 8.0


def test_bc7_roundtrip_random_noise_bounded():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (32, 32, 4), np.uint8)
    out = bc7.decompress_bc7(bc7.compress_bc7_mode6(img), 32, 32)
    # Noise is the worst case for one line segment per block; error stays
    # bounded by the endpoint span but the mean must be sane.
    err = np.abs(out.astype(int) - img.astype(int))
    assert err.mean() < 60


def test_bc7_constant_block_exact():
    img = np.full((4, 4, 4), (200, 64, 32, 255), np.uint8)
    out = bc7.decompress_bc7(bc7.compress_bc7_mode6(img), 4, 4)
    assert np.abs(out.astype(int) - img.astype(int)).max() <= 1


def test_bc7_alpha_preserved():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (8, 8, 4), np.uint8)
    img[..., 3] = np.linspace(10, 250, 8).astype(np.uint8)[:, None]
    out = bc7.decompress_bc7(bc7.compress_bc7_mode6(img), 8, 8)
    assert np.abs(out[..., 3].astype(int) - img[..., 3].astype(int)).mean() < 40


def test_bc7_mode0_zero_block_decodes_black():
    """A zero-filled mode-0 block (all endpoints 0) decodes to opaque black
    — all modes are now fully decoded (round 1 flagged non-6 modes
    magenta)."""
    blk = np.zeros((1, 16), np.uint8)
    blk[0, 0] = 1  # mode 0 marker
    out = bc7.decompress_bc7(blk, 4, 4)
    assert (out == np.array([0, 0, 0, 255], np.uint8)).all()


def test_bc7_two_color_block_near_exact():
    """Texels exactly at the two endpoints must decode back to them (up to
    the 7+1-bit endpoint quantization): exercises the full bit layout —
    endpoints, p-bits, anchor index, and the 4-bit weight table."""
    rng = np.random.default_rng(5)
    a = np.array([24, 200, 96, 255], np.uint8)
    b = np.array([230, 40, 180, 128], np.uint8)
    img = np.where(rng.random((4, 4, 1)) < 0.5, a[None, None], b[None, None])
    out = bc7.decompress_bc7(bc7.compress_bc7_mode6(img), 4, 4)
    assert np.abs(out.astype(int) - img.astype(int)).max() <= 2


def test_bc7_dds_container_roundtrip():
    import struct

    from arkoserenderer.assets import external as ext

    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (8, 8, 4), np.uint8)
    blocks = bc7.compress_bc7_mode6(img)
    pf = struct.pack("<II4sIIIII", 32, 0x4, b"DX10", 0, 0, 0, 0, 0)
    hdr = (b"DDS " + struct.pack("<7I", 124, 0x1007, 8, 8, 0, 0, 1)
           + b"\0" * 44 + pf + b"\0" * 20)
    dx10 = struct.pack("<5I", 98, 3, 0, 1, 0)  # DXGI_FORMAT_BC7_UNORM
    dds = ext.DDSImage.parse(hdr + dx10 + blocks.tobytes())
    assert dds.fourcc == "BC7 "
    err = np.abs(dds.mips[0].astype(int) - img.astype(int))
    assert err.mean() < 60  # mode-6 noise bound (see roundtrip test above)


def test_bc7_all_modes_match_independent_decoder():
    """Fuzz the FULL 8-mode decoder block-for-block against Pillow's BCn
    codec (an independent implementation of the BC7 spec): random bits with
    a forced mode marker are valid blocks, so this covers every mode's
    partitions, p-bits, rotations, and dual index sets."""
    import numpy as np
    import pytest

    try:
        from PIL import Image

        Image.frombytes("RGBA", (4, 4), b"\x00" * 16, "bcn", (7, "RGBA"))
    except Exception:
        pytest.skip("Pillow BCn decoder unavailable")

    from arkoserenderer.assets.bc7 import decompress_bc7

    rng = np.random.default_rng(7)
    for mode in range(8):
        n = 256
        raw = rng.integers(0, 256, (n, 16), dtype=np.uint8)
        b0 = raw[:, 0].astype(np.int64)
        b0 = ((b0 >> (mode + 1)) << (mode + 1)) | (1 << mode)
        raw[:, 0] = b0.astype(np.uint8)
        ours = decompress_bc7(raw, 4, 4 * n)
        ref = np.asarray(
            Image.frombytes("RGBA", (4 * n, 4), raw.tobytes(), "bcn", (7, "RGBA"))
        )
        np.testing.assert_array_equal(ours, ref, err_msg=f"mode {mode}")


# -- full-profile encoder (round 3) -------------------------------------------


def _psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0**2 / max(mse, 1e-9))


def _test_image(alpha: bool):
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:32, 0:32].astype(np.float64)
    img = np.stack(
        [128 + 100 * np.sin(x / 9), 128 + 100 * np.cos(y / 11),
         128 + 80 * np.sin((x + y) / 13), np.full_like(x, 255)], -1)
    img[..., :3] = np.clip(img[..., :3] + rng.normal(0, 4, (32, 32, 3)), 0, 255)
    img[12:24, 4:28, :3] = (230, 40, 40)  # two-tone blocks favor partitions
    if alpha:
        img[..., 3] = np.clip(x * 8, 0, 255)
    return img.astype(np.uint8)


def test_bc7_full_profile_beats_mode6():
    """compress_bc7's mode search must not lose to the mode-6 baseline, and
    higher tiers must not lose to lower ones (candidate sets are supersets)."""
    for alpha in (False, True):
        img = _test_image(alpha)
        scores = []
        for q in ("fast", "balanced", "thorough"):
            out = bc7.decompress_bc7(bc7.compress_bc7(img, quality=q), 32, 32)
            scores.append(_psnr(img, out))
        assert scores[1] >= scores[0] - 1e-6, scores
        assert scores[2] >= scores[1] - 1e-6, scores
        assert scores[2] > scores[0] + 0.5, f"mode search won nothing: {scores}"


def test_bc7_encoder_emits_partitioned_and_rotation_modes():
    opaque = _test_image(alpha=False)
    blocks = bc7.compress_bc7(opaque, quality="thorough")
    modes = set(np.argmax(bc7._unpack_bits(blocks), axis=1).tolist())
    assert modes & {0, 1, 2, 3}, f"no partitioned opaque mode chosen: {modes}"
    translucent = _test_image(alpha=True)
    blocks = bc7.compress_bc7(translucent, quality="thorough")
    modes = set(np.argmax(bc7._unpack_bits(blocks), axis=1).tolist())
    assert modes & {4, 5, 7}, f"no alpha mode chosen: {modes}"


def test_bc7_encoded_streams_valid_for_independent_decoder():
    """Encoded blocks must decode identically in Pillow's independent BC7
    implementation — i.e. we emit spec-valid bitstreams, not just streams
    our own decoder happens to accept."""
    import pytest

    try:
        from PIL import Image

        Image.frombytes("RGBA", (4, 4), b"\x00" * 16, "bcn", (7, "RGBA"))
    except Exception:
        pytest.skip("Pillow BCn decoder unavailable")

    for alpha in (False, True):
        img = _test_image(alpha)
        blocks = bc7.compress_bc7(img, quality="thorough")
        ours = bc7.decompress_bc7(blocks, 32, 32)
        h, w = 32, 32
        # Pillow lays blocks out row-major over the image like our packer.
        ref = np.asarray(
            Image.frombytes("RGBA", (w, h), blocks.tobytes(), "bcn", (7, "RGBA"))
        )
        np.testing.assert_array_equal(ours, ref)
        assert _psnr(img, ref) > 30.0


def test_bc7_rdo_trades_size_for_bounded_error():
    """rdo_bc7 (the bc7enc_rdo slot): higher lambda must shrink the
    LZ-compressed size monotonically-ish while keeping decoded error
    bounded, and lambda=0 must be a no-op."""
    import zlib

    rng = np.random.default_rng(3)
    img = np.zeros((64, 64, 4), np.uint8)
    img[..., 3] = 255
    img[..., :3] = (90, 120, 150)
    img[:, :32, :3] = (200, 80, 60)
    img[..., :3] = np.clip(
        img[..., :3].astype(float) + rng.normal(0, 3, (64, 64, 3)), 0, 255
    ).astype(np.uint8)

    blocks = bc7.compress_bc7(img, quality="balanced")
    assert np.array_equal(bc7.rdo_bc7(img, blocks, 0.0), blocks)

    base_size = len(zlib.compress(blocks.tobytes(), 6))
    base_psnr = _psnr(img, bc7.decompress_bc7(blocks, 64, 64))
    rb = bc7.compress_bc7(img, quality="balanced", rdo_lambda=4.0)
    rdo_size = len(zlib.compress(rb.tobytes(), 6))
    rdo_psnr = _psnr(img, bc7.decompress_bc7(rb, 64, 64))
    assert rdo_size < base_size * 0.95, (rdo_size, base_size)
    assert rdo_psnr > base_psnr - 3.0, (rdo_psnr, base_psnr)
