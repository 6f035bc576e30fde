"""Environment light evaluation.

Reimplementation of ``GetEnvironmentLightColor``
(/root/reference/Shaders/ShadingHelpers.hlsli:11-30): lat-long texture if
present (rotated by the environment transform), else a constant color if its
alpha >= 0, else the procedural sky gradient
``Color::FromSrgb(lerp(1, (0.5, 0.7, 1), (dir.y + 1) / 2))``.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from ..utils import math as m


@struct.dataclass
class EnvironmentLight:
    """Environment light state (Scene.ixx:64-94 EnvironmentLightBase)."""
    color: jnp.ndarray       # (4,); alpha < 0 -> procedural sky fallback
    rotation: jnp.ndarray    # (4,) quaternion applied to the lookup direction
    texture: jnp.ndarray | None = None  # (H, W, 3) lat-long radiance or None
    # Quarter-res mip (post.generate_mips, the MipmapGeneration.hlsl role):
    # deep-bounce fetches read this — their cone footprint wants the
    # area-filtered value, from a 16x smaller gather source (same policy
    # as texpack.rows_half).
    texture_low: jnp.ndarray | None = None


def make_environment_light(color=(0.0, 0.0, 0.0, -1.0),
                           rotation=m.QUAT_IDENTITY,
                           texture=None) -> EnvironmentLight:
    texture_low = None
    if texture is not None:
        from . import post   # local import: post imports nothing from sky
        h, w = texture.shape[0], texture.shape[1]
        levels = 2 if (h % 4 == 0 and w % 4 == 0) else 0
        if levels:
            texture_low = post.generate_mips(texture, levels)[-1]
    return EnvironmentLight(color=jnp.asarray(color, jnp.float32),
                            rotation=jnp.asarray(rotation, jnp.float32),
                            texture=texture, texture_low=texture_low)


def procedural_sky(direction):
    """ShadingHelpers.hlsli:29 gradient fallback (sRGB-encoded lerp)."""
    t = (direction[..., 1:2] + 1.0) * 0.5
    srgb = m.lerp(jnp.ones((3,), jnp.float32),
                  jnp.array([0.5, 0.7, 1.0], jnp.float32), t)
    return m.from_srgb(srgb)


def _sample_latlong_bilinear(texture, direction):
    h, w = texture.shape[0], texture.shape[1]
    uv = m.to_latlong(direction)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = jnp.floor(x)
    # Clamp the row BEFORE the fraction: at the poles y < 0 (or > h-1) and
    # an unclamped fraction blends the two outermost rows — invisible at
    # full res (neighbor rows are near-equal) but wrong on coarse mips.
    y0 = jnp.clip(jnp.floor(y), 0, h - 1)
    fx = (x - x0)[..., None]
    fy = jnp.clip(y - y0, 0.0, 1.0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    y0i = y0.astype(jnp.int32)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    c00 = texture[y0i, x0i]
    c10 = texture[y0i, x1i]
    c01 = texture[y1i, x0i]
    c11 = texture[y1i, x1i]
    return m.lerp(m.lerp(c00, c10, fx), m.lerp(c01, c11, fx), fy)


def environment_color(env: EnvironmentLight, direction, wide: bool = False):
    """Evaluate the environment light for (..., 3) world directions.

    wide=True marks wide-footprint callers (deep bounces past the
    texture_bounces cutoff, ops/pathtrace.py): they read the quarter-res
    mip — area-filtered, and a far smaller random-gather source."""
    tex = env.texture
    if wide and env.texture_low is not None:
        tex = env.texture_low
    if tex is not None:
        d = m.normalize(m.quat_rotate(env.rotation, direction))
        return _sample_latlong_bilinear(tex, d)
    has_color = env.color[3] >= 0.0
    return jnp.where(has_color, env.color[:3], procedural_sky(direction))
