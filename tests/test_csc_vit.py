"""YUV→RGB conversion, resize, and the ViT feed (config 5)."""

import jax
import jax.numpy as jnp
import numpy as np

from hvqm4_jax.models.vit import ViTConfig, init_vit, vit_encode
from hvqm4_jax.ops.csc import frame_to_rgb, resize_bilinear, yuv_to_rgb


def _ref_rgb(y, u, v):
    yi = y.astype(np.int64)
    ui = u.astype(np.int64) - 128
    vi = v.astype(np.int64) - 128
    r = yi + ((91881 * vi + 32768) >> 16)
    g = yi - ((22554 * ui + 46802 * vi + 32768) >> 16)
    b = yi + ((116130 * ui + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def test_yuv_to_rgb_exact():
    rng = np.random.default_rng(0)
    y, u, v = (rng.integers(0, 256, (32, 48), dtype=np.uint8) for _ in range(3))
    got = np.asarray(yuv_to_rgb(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)))
    assert np.array_equal(got, _ref_rgb(y, u, v))


def test_yuv_gray_maps_to_gray():
    y = np.full((16, 16), 77, np.uint8)
    c = np.full((16, 16), 128, np.uint8)
    got = np.asarray(yuv_to_rgb(jnp.asarray(y), jnp.asarray(c), jnp.asarray(c)))
    assert (got == 77).all()


def test_frame_to_rgb_420_upsample():
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (32, 48), dtype=np.uint8)
    u = rng.integers(0, 256, (16, 24), dtype=np.uint8)
    v = rng.integers(0, 256, (16, 24), dtype=np.uint8)
    rgb = np.asarray(frame_to_rgb([jnp.asarray(y), jnp.asarray(u),
                                   jnp.asarray(v)], 2, 2))
    up = np.repeat(np.repeat(u, 2, 0), 2, 1)
    vp = np.repeat(np.repeat(v, 2, 0), 2, 1)
    assert np.array_equal(rgb, _ref_rgb(y, up, vp))


def test_resize_shape_and_range():
    img = jnp.asarray(np.random.default_rng(2).integers(
        0, 256, (48, 64, 3), dtype=np.uint8))
    out = np.asarray(resize_bilinear(img, 224, 224))
    assert out.shape == (224, 224, 3)
    assert out.min() >= 0.0 and out.max() <= 1.0


def test_vit_encode_shapes_and_grad_free_forward():
    cfg = ViTConfig(image_size=32, patch_size=8, dim=64, depth=2, heads=4)
    params = init_vit(cfg, jax.random.key(0))
    imgs = jnp.asarray(np.random.default_rng(3).random((3, 32, 32, 3)),
                       jnp.float32)
    emb = jax.jit(lambda p, x: vit_encode(p, cfg, x))(params, imgs)
    assert emb.shape == (3, cfg.dim)
    assert np.isfinite(np.asarray(emb)).all()
    # deterministic
    emb2 = jax.jit(lambda p, x: vit_encode(p, cfg, x))(params, imgs)
    assert np.array_equal(np.asarray(emb), np.asarray(emb2))


def test_frame_to_rgb_640x480_matches_bt601():
    """A full 640x480 4:2:0 frame against the NumPy BT.601 reference."""
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (480, 640), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (240, 320), dtype=np.uint8)
            for _ in range(2))
    got = np.asarray(frame_to_rgb([jnp.asarray(y), jnp.asarray(u),
                                   jnp.asarray(v)], 2, 2))
    up = np.repeat(np.repeat(u, 2, 0), 2, 1)
    vp = np.repeat(np.repeat(v, 2, 0), 2, 1)
    assert np.array_equal(got, _ref_rgb(y, up, vp))
