"""Microfacet BRDF terms and importance sampling.

Reimplementation of the MathLib pieces the reference's BxDF layer
calls into (SURVEY.md §2.3 "NVIDIA MathLib (ml)" row; call sites in
/root/reference/Shaders/BxDF.hlsli): ``BRDF::DistributionTerm`` (GGX),
``BRDF::GeometryTermMod`` (height-correlated Smith visibility),
``BRDF::FresnelTerm`` (Schlick) and dielectric Fresnel,
``BRDF::DiffuseTerm`` (Burley), ``BRDF::EnvironmentTerm_Rtg`` (split-sum
environment approximation), and ``ImportanceSampling::{Cosine,VNDF,Uniform}``.

All functions are elementwise over broadcastable arrays. Scalar inputs
(roughness, cosines) have shape (...,); colors/vectors are (..., 3).
Conventions: `roughness` is the *linear* (perceptual) roughness; alpha
= roughness^2; all cosines are expected pre-clamped >= 0 by the caller.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import math as m

PI = jnp.float32(jnp.pi)
INV_PI = jnp.float32(1.0 / jnp.pi)


# ----------------------------------------------------------------------------
# Microfacet terms


def distribution_ggx(roughness, noh):
    """GGX normal distribution D (BRDF::DistributionTerm)."""
    a = roughness * roughness
    a2 = a * a
    d = noh * noh * (a2 - 1.0) + 1.0
    return a2 / jnp.maximum(PI * d * d, 1e-10)


def geometry_term_mod(roughness, nol, nov):
    """Height-correlated Smith visibility V = G2 / (4 NoL NoV)
    (BRDF::GeometryTermMod). Multiply by D and F for the full specular BRDF."""
    a = roughness * roughness
    a2 = a * a
    gv = nol * jnp.sqrt(jnp.maximum(nov * nov * (1.0 - a2) + a2, 0.0))
    gl = nov * jnp.sqrt(jnp.maximum(nol * nol * (1.0 - a2) + a2, 0.0))
    return 0.5 / jnp.maximum(gv + gl, 1e-8)


def smith_g1(roughness, nov):
    """Smith masking G1 for GGX."""
    a = roughness * roughness
    a2 = a * a
    return 2.0 * nov / jnp.maximum(
        nov + jnp.sqrt(jnp.maximum(a2 + (1.0 - a2) * nov * nov, 0.0)), 1e-8)


def fresnel_schlick(f0, voh):
    """Schlick Fresnel; f0 is (..., 3), voh (...,)."""
    return f0 + (1.0 - f0) * jnp.power(
        jnp.clip(1.0 - voh[..., None], 0.0, 1.0), 5.0)


def fresnel_dielectric(eta, voh):
    """Exact unpolarized dielectric Fresnel (BRDF::FresnelTerm_Dielectric).

    eta = IORi / IORo (ratio of the incident side over transmitted side);
    voh = |cos| of the angle between V and the microfacet normal.
    Returns 1 under total internal reflection.
    """
    cos_i = jnp.clip(voh, 0.0, 1.0)
    sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
    tir = sin_t2 >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t2, 0.0))
    # eta here converts: r_parallel/perp with n1=eta-side. Using ratio form.
    rs = (eta * cos_i - cos_t) / jnp.maximum(eta * cos_i + cos_t, 1e-8)
    rp = (cos_i - eta * cos_t) / jnp.maximum(cos_i + eta * cos_t, 1e-8)
    f = 0.5 * (rs * rs + rp * rp)
    return jnp.where(tir, 1.0, jnp.clip(f, 0.0, 1.0))


def diffuse_term_burley(roughness, nol, nov, voh):
    """Burley (Disney) diffuse, normalized by pi (BRDF::DiffuseTerm)."""
    f90 = 0.5 + 2.0 * roughness * voh * voh
    light = 1.0 + (f90 - 1.0) * jnp.power(jnp.clip(1.0 - nol, 0.0, 1.0), 5.0)
    view = 1.0 + (f90 - 1.0) * jnp.power(jnp.clip(1.0 - nov, 0.0, 1.0), 5.0)
    return INV_PI * light * view


def environment_term_rtg(f0, nov, roughness):
    """Preintegrated split-sum environment BRDF approximation
    (BRDF::EnvironmentTerm_Rtg — "Ray Tracing Gems" fit used by MathLib/NRD).

    Rational fit in (NoV, alpha); returns (..., 3) in [0, 1].
    """
    a = m.saturate(roughness * roughness)
    x1 = jnp.ones_like(nov)
    x2, x3 = nov, nov * nov
    x4 = nov * x3
    y1 = jnp.ones_like(a)
    y2, y3 = a, a * a
    y4 = a * y3

    def dot2x2(m00, m01, m10, m11, xa, xb, ya, yb):
        return (m00 * xa + m01 * xb) * ya + (m10 * xa + m11 * xb) * yb

    def dot3x3(mat, xs, ys):
        acc = 0.0
        for i in range(3):
            row = mat[3 * i] * xs[0] + mat[3 * i + 1] * xs[1] + mat[3 * i + 2] * xs[2]
            acc = acc + row * ys[i]
        return acc

    bias_num = dot2x2(0.99044, -1.28514, 1.29678, -0.755907, x1, x2, y1, y2)
    bias_den = dot3x3([1.0, 2.92338, 59.4188,
                       20.3225, -27.0302, 222.592,
                       121.563, 626.13, 316.627],
                      (x1, x2, x4), (y1, y2, y4))
    scale_num = dot2x2(0.0365463, 3.32707, 9.0632, -9.04756, x1, x2, y1, y2)
    scale_den = dot3x3([1.0, 3.59685, -1.36772,
                        9.04401, -16.3174, 9.22949,
                        5.56589, 19.7886, -20.2123],
                       (x1, x3, x4), (y1, y2, y4))
    bias = bias_num / jnp.maximum(bias_den, 1e-6)
    scale = scale_num / jnp.maximum(scale_den, 1e-6)
    return m.saturate(f0 * scale[..., None] + bias[..., None])


# ----------------------------------------------------------------------------
# Importance sampling (local/tangent space: +z = normal)


def sample_cosine_hemisphere(random2):
    """Cosine-weighted hemisphere direction (ImportanceSampling::Cosine)."""
    phi = 2.0 * PI * random2[..., 0]
    cos_theta2 = 1.0 - random2[..., 1]
    cos_theta = jnp.sqrt(cos_theta2)
    sin_theta = jnp.sqrt(jnp.maximum(random2[..., 1], 0.0))
    return jnp.stack([sin_theta * jnp.cos(phi),
                      sin_theta * jnp.sin(phi),
                      cos_theta], axis=-1)


def pdf_cosine_hemisphere(nol):
    return nol * INV_PI


def sample_uniform_disk(random2):
    """Uniform unit-disk point (ImportanceSampling::Uniform, thin lens)."""
    r = jnp.sqrt(random2[..., 0])
    phi = 2.0 * PI * random2[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def sample_vndf_ggx(random2, roughness, v_local):
    """Heitz 2018 VNDF sampling of the GGX distribution of visible normals.

    v_local is the view vector in tangent space (+z up). Returns the
    half-vector H in tangent space (ImportanceSampling::VNDF::GetRay).
    """
    a = (roughness * roughness)[..., None]
    vh = m.normalize(v_local * jnp.concatenate(
        [a, a, jnp.ones_like(a)], axis=-1))
    # orthonormal basis around vh
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = jnp.where(
        (lensq > 1e-12)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(lensq)], axis=-1)
        * jax_rsqrt(lensq)[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], vh.dtype), vh.shape))
    t2 = m.cross(vh, t1)
    r = jnp.sqrt(jnp.clip(random2[..., 0], 0.0, 1.0))
    phi = 2.0 * PI * random2[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h = jnp.stack([a[..., 0] * nh[..., 0],
                   a[..., 0] * nh[..., 1],
                   jnp.maximum(nh[..., 2], 0.0)], axis=-1)
    return m.normalize(h)


def pdf_vndf_ggx(roughness, noh, nov_local):
    """Solid-angle PDF of the reflected direction L for VNDF-sampled H:
    pdf(L) = G1(V) * D(H) / (4 * NoV) (ImportanceSampling::VNDF::GetPDF)."""
    d = distribution_ggx(roughness, noh)
    g1 = smith_g1(roughness, jnp.maximum(nov_local, 1e-6))
    return g1 * d / jnp.maximum(4.0 * nov_local, 1e-6)


def jax_rsqrt(x):
    return jnp.reciprocal(jnp.sqrt(jnp.maximum(x, 1e-30)))
