"""Motion-vector history reprojection, shared by the temporal passes.

TAA upscale, the denoisers' accumulation and ReSTIR temporal reuse each
resample a history buffer at ``current pixel + motion`` — the texture
fetch of the reference's shaders, here a row gather from the flattened
(H*W, C) buffer.
"""

from __future__ import annotations

import jax.numpy as jnp


def bilinear_sample(img, y, x):
    """Clamp-addressed bilinear gather: img (H, W, C), y/x (...) pixel-index
    coordinates (pixel centers at integers) -> (..., C)."""
    h, w = img.shape[0], img.shape[1]
    y0 = jnp.floor(y)
    x0 = jnp.floor(x)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    flat = img.reshape(-1, img.shape[-1])
    c00 = flat[y0i * w + x0i]
    c01 = flat[y0i * w + x1i]
    c10 = flat[y1i * w + x0i]
    c11 = flat[y1i * w + x1i]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) \
        + (c10 * (1 - fx) + c11 * fx) * fy


def reproject(src, motion, history_filter: str = "nearest"):
    """History fetch of src (H, W, C) at pixel + motion (H, W, 2) [x, y].

    Returns (prev (H, W, C), in_bounds (H, W)): in_bounds is False where
    the source position leaves the frame (callers treat that as
    disocclusion). "nearest" copies one source row unchanged, so it is
    safe on f16-packed bit payloads; "bilinear" blends 4 taps and needs
    plain float channels.
    """
    h, w = src.shape[:2]
    prev_y = jnp.arange(h, dtype=jnp.float32)[:, None] + motion[..., 1]
    prev_x = jnp.arange(w, dtype=jnp.float32)[None, :] + motion[..., 0]
    if history_filter == "nearest":
        yi = jnp.clip(jnp.round(prev_y).astype(jnp.int32), 0, h - 1)
        xi = jnp.clip(jnp.round(prev_x).astype(jnp.int32), 0, w - 1)
        prev = src.reshape(-1, src.shape[-1])[yi * w + xi]
    elif history_filter == "bilinear":
        prev = bilinear_sample(src, prev_y, prev_x)
    else:
        raise ValueError(f"unknown history filter {history_filter!r}")
    in_bounds = ((prev_x >= 0) & (prev_x <= w - 1)
                 & (prev_y >= 0) & (prev_y <= h - 1))
    return prev, in_bounds
