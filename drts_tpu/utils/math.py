"""Vector / quaternion / frame math — the framework's core math module.

Replacement for NVIDIA MathLib (``ml.hlsli``) used throughout the
reference (cited via SURVEY.md §2.3: ``Geometry::*``, ``Color::*``,
``Math::*`` in /root/reference/Shaders/Math.hlsli and Camera.hlsli).

All functions are pure, elementwise over a trailing component axis, and
therefore trivially vmappable/shardable. Colors and vectors are ``(..., 3)``
float32 arrays; quaternions are ``(..., 4)`` arrays in (x, y, z, w) order.
"""

from __future__ import annotations

import jax.numpy as jnp

# ----------------------------------------------------------------------------
# scalar helpers


def sqr(x):
    return x * x


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def safe_div(a, b, eps: float = 1e-20):
    """a / b with sign-preserving clamp of |b| away from zero."""
    return a / jnp.where(jnp.abs(b) < eps, jnp.where(b < 0, -eps, eps), b)


def sign_not_zero(x):
    """+1 for x >= 0, -1 for x < 0 (HLSL ``Math::Sign`` semantics)."""
    return jnp.where(x >= 0, 1.0, -1.0)


# ----------------------------------------------------------------------------
# vectors (trailing axis = components)


def dot(a, b, keepdims: bool = False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def length(v, keepdims: bool = False):
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 0.0))


def normalize(v, eps: float = 1e-20):
    return v * jnp.reciprocal(jnp.maximum(length(v, keepdims=True), eps))


def cross(a, b):
    return jnp.cross(a, b)


def reflect(i, n):
    """HLSL reflect: i - 2*dot(i,n)*n (i points toward the surface)."""
    return i - 2.0 * dot(i, n, keepdims=True) * n


def refract(i, n, eta):
    """HLSL refract. Returns (refracted_dir, total_internal_reflection_mask).

    ``i`` points toward the surface, ``n`` away from it, ``eta`` = IORi/IORo.
    Where TIR occurs the returned direction is 0 (as HLSL does).
    """
    eta = jnp.asarray(eta)[..., None]
    cosi = -dot(i, n, keepdims=True)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k[..., 0] < 0.0
    dir_ = eta * i + (eta * cosi - jnp.sqrt(jnp.maximum(k, 0.0))) * n
    return jnp.where(tir[..., None], 0.0, dir_), tir


def vec3(x, y, z):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(z, jnp.float32)), axis=-1)


def lerp(a, b, t):
    return a + (b - a) * t


# ----------------------------------------------------------------------------
# quaternions (x, y, z, w)

QUAT_IDENTITY = jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], axis=-1)


def quat_conj(q):
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], q.dtype)


def quat_rotate(q, v):
    """Rotate vector v by quaternion q."""
    qv = q[..., :3]
    t = 2.0 * cross(qv, v)
    return v + q[..., 3:4] * t + cross(qv, t)


def quat_from_axis_angle(axis, angle):
    axis = normalize(jnp.asarray(axis, jnp.float32))
    angle = jnp.asarray(angle, jnp.float32)
    half = 0.5 * angle
    s = jnp.sin(half)[..., None]
    return jnp.concatenate([axis * s, jnp.cos(half)[..., None]], axis=-1)


def quat_integrate(q, omega, dt):
    """Integrate angular velocity (rad/s, world frame) over dt; renormalize."""
    omega_q = jnp.concatenate([omega, jnp.zeros_like(omega[..., :1])], axis=-1)
    dq = 0.5 * quat_mul(omega_q, q)
    return normalize(q + dq * dt)


def quat_to_matrix(q):
    """(..., 4) quaternion -> (..., 3, 3) rotation matrix (rows = basis)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack([
        1 - 2 * (yy + zz), 2 * (xy + wz), 2 * (xz - wy),
        2 * (xy - wz), 1 - 2 * (xx + zz), 2 * (yz + wx),
        2 * (xz + wy), 2 * (yz - wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# ----------------------------------------------------------------------------
# frames / bases


def calculate_tbn(n, t):
    """Gram-Schmidt TBN rows (T', B, N) — ``Math::CalculateTBN``
    (/root/reference/Shaders/Math.hlsli:18-22)."""
    t = normalize(t - n * dot(n, t, keepdims=True))
    b = cross(n, t)
    return t, b, n


def orthonormal_basis(n):
    """Branchless tangent basis from a unit normal (Duff et al. / Pixar).

    The reference uses MathLib ``Geometry::GetBasis``; this is the standard
    sign-trick construction: returns (t, b) with (t, b, n) right-handed.
    """
    s = sign_not_zero(n[..., 2])
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b,
                   -s * n[..., 0]], axis=-1)
    bt = jnp.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bt


def to_local(t, b, n, v):
    """World -> tangent space (``Geometry::RotateVector`` with basis rows)."""
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def to_world(t, b, n, v):
    """Tangent -> world space (``Geometry::RotateVectorInverse``)."""
    return (v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n)


# ----------------------------------------------------------------------------
# screen-space mappings (Math.hlsli:5-16)


def calculate_uv(pixel_xy, dims_xy, jitter_xy=0.0):
    """(pixel + 0.5 + jitter) / dims — Math::CalculateUV."""
    return (pixel_xy + 0.5 + jitter_xy) / dims_xy


def calculate_ndc(uv):
    """UV -> NDC: x in [-1,1], y flipped — Math::CalculateNDC."""
    return uv * jnp.array([2.0, -2.0]) + jnp.array([-1.0, 1.0])


def to_latlong(direction):
    """Unit direction -> lat-long UV — Math::ToLatLongCoordinate."""
    u = (1.0 + jnp.arctan2(direction[..., 0], direction[..., 2]) / jnp.pi) / 2
    v = jnp.arccos(jnp.clip(direction[..., 1], -1.0, 1.0)) / jnp.pi
    return jnp.stack([u, v], axis=-1)


def sample_triangle(random2):
    """Uniform barycentrics from 2 uniforms — Math::SampleTriangle."""
    value = jnp.sqrt(random2[..., 0])
    return jnp.stack([value * (1.0 - random2[..., 1]),
                      value * random2[..., 1]], axis=-1)


def to_solid_angle_pdf(area_pdf, dist, cos_theta, eps: float = 1e-8):
    """Area-measure PDF -> solid-angle PDF — Math::ToSolidAnglePDF."""
    return area_pdf * dist * dist / jnp.maximum(cos_theta, eps)


# ----------------------------------------------------------------------------
# color (MathLib Color::*)

_LUMA = jnp.array([0.2126, 0.7152, 0.0722], jnp.float32)


def luminance(rgb):
    return jnp.sum(rgb * _LUMA, axis=-1)


def from_srgb(c):
    """sRGB -> linear."""
    c = jnp.asarray(c, jnp.float32)
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def to_srgb(c):
    """Linear -> sRGB."""
    c = jnp.maximum(jnp.asarray(c, jnp.float32), 0.0)
    return jnp.where(c <= 0.0031308, c * 12.92,
                     1.055 * jnp.power(c, 1.0 / 2.4) - 0.055)


# ----------------------------------------------------------------------------
# packing (Shaders/Packing.hlsli equivalents; used by the G-buffer)


def oct_encode(n):
    """Unit vector -> octahedral [-1,1]^2 (Packing::EncodeUnitVector)."""
    n = n / jnp.sum(jnp.abs(n), axis=-1, keepdims=True)
    xy = n[..., :2]
    flipped = (1.0 - jnp.abs(xy[..., ::-1])) * sign_not_zero(xy)
    return jnp.where(n[..., 2:3] >= 0.0, xy, flipped)


def oct_decode(e):
    """Octahedral [-1,1]^2 -> unit vector."""
    x, y = e[..., 0], e[..., 1]
    z = 1.0 - jnp.abs(x) - jnp.abs(y)
    t = jnp.maximum(-z, 0.0)
    x = x - sign_not_zero(x) * t
    y = y - sign_not_zero(y) * t
    return normalize(jnp.stack([x, y, z], axis=-1))


def pack2f16(a, b):
    """Two f32 -> one f32 carrying their f16 bit patterns (the RGBA16F
    history-texture layout NRD uses, halving gathered row bytes). Values
    are clamped to the f16 range; precision loss ~2^-10 relative."""
    import jax
    lim = 60000.0
    ah = jnp.clip(a, -lim, lim).astype(jnp.float16)
    bh = jnp.clip(b, -lim, lim).astype(jnp.float16)
    au = jax.lax.bitcast_convert_type(ah, jnp.uint16).astype(jnp.uint32)
    bu = jax.lax.bitcast_convert_type(bh, jnp.uint16).astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(au | (bu << jnp.uint32(16)),
                                        jnp.float32)


def unpack2f16(x):
    """Inverse of pack2f16: one bit-packed f32 -> (a, b) f32."""
    import jax
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    a = jax.lax.bitcast_convert_type((u & jnp.uint32(0xFFFF)).astype(
        jnp.uint16), jnp.float16)
    b = jax.lax.bitcast_convert_type((u >> jnp.uint32(16)).astype(
        jnp.uint16), jnp.float16)
    return a.astype(jnp.float32), b.astype(jnp.float32)


def pack_oct16(n):
    """Unit vector -> one f32 (octahedral xy as an f16 pair)."""
    e = oct_encode(n)
    return pack2f16(e[..., 0], e[..., 1])


def unpack_oct16(x):
    """Inverse of pack_oct16."""
    a, b = unpack2f16(x)
    return oct_decode(jnp.stack([a, b], axis=-1))


def pack_depth_oct8(depth, n):
    """Depth (f16, clamped) + unit normal (octahedral 2x8-bit unorm, ~1-2
    degrees error — fine for >= 0.5-dot similarity guides) in ONE f32."""
    import jax
    dh = jnp.clip(depth, -3e4, 3e4).astype(jnp.float16)
    du = jax.lax.bitcast_convert_type(dh, jnp.uint16).astype(jnp.uint32)
    e = oct_encode(n)
    q = jnp.round((e * 0.5 + 0.5) * 255.0).astype(jnp.uint32)
    u = (du << jnp.uint32(16)) | (q[..., 0] << jnp.uint32(8)) | q[..., 1]
    return jax.lax.bitcast_convert_type(u, jnp.float32)


def unpack_depth_oct8(x):
    """Inverse of pack_depth_oct8 -> (depth, normal)."""
    import jax
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    dh = jax.lax.bitcast_convert_type(
        (u >> jnp.uint32(16)).astype(jnp.uint16), jnp.float16)
    q0 = ((u >> jnp.uint32(8)) & jnp.uint32(255)).astype(jnp.float32)
    q1 = (u & jnp.uint32(255)).astype(jnp.float32)
    e = jnp.stack([q0, q1], axis=-1) / 255.0 * 2.0 - 1.0
    return dh.astype(jnp.float32), oct_decode(e)
