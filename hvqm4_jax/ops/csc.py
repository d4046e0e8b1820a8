"""On-device color-space conversion and resize (BASELINE config 5 front half).

The reference's YUV→RGB lived host-side in its CLI (SURVEY.md §2.3 "frame
dump"); here the conversion runs on device so decoded frames can feed
straight into a vision model without ever visiting the host.

Fixed-point integer BT.601 full-range (defined normatively here — the oracle's
conformance surface is YUV; RGB is downstream):

    R = clip_u8( Y + (91881·(V−128) + 32768 >> 16) )
    G = clip_u8( Y − (22554·(U−128) + 46802·(V−128) + 32768 >> 16) )
    B = clip_u8( Y + (116130·(U−128) + 32768 >> 16) )

Chroma upsampling for 4:2:0 is sample replication (nearest), matching the
codec's blocky aesthetic and keeping the op integer-exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .device_core import _sra  # one shared sign-propagating shift


def upsample_chroma(c: jnp.ndarray, h_samp: int, v_samp: int) -> jnp.ndarray:
    if v_samp == 2:
        c = jnp.repeat(c, 2, axis=-2)
    if h_samp == 2:
        c = jnp.repeat(c, 2, axis=-1)
    return c


@jax.jit
def yuv_to_rgb(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Full-resolution planes (chroma already upsampled) → (H, W, 3) u8."""
    yi = y.astype(jnp.int32)
    ui = u.astype(jnp.int32) - 128
    vi = v.astype(jnp.int32) - 128
    r = yi + _sra(91881 * vi + 32768, 16)
    g = yi - _sra(22554 * ui + 46802 * vi + 32768, 16)
    b = yi + _sra(116130 * ui + 32768, 16)
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(rgb, 0, 255).astype(jnp.uint8)


def frame_to_rgb(planes, h_samp: int, v_samp: int) -> jnp.ndarray:
    """[Y, U, V] session planes → (H, W, 3) u8 on device."""
    y, u, v = planes
    uu = upsample_chroma(u, h_samp, v_samp)
    vv = upsample_chroma(v, h_samp, v_samp)
    return yuv_to_rgb(y, uu, vv)


def resize_bilinear(img: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """u8 (H, W, C) → f32 (out_h, out_w, C) in [0, 1], on device.

    HIGHEST precision: `jax.image.resize` contracts with weight matrices,
    which a GPU would otherwise run in TF32 (about three decimal digits)."""
    f = img.astype(jnp.float32) / 255.0
    return jax.image.resize(f, (out_h, out_w, img.shape[-1]), method="bilinear",
                            precision=jax.lax.Precision.HIGHEST)
