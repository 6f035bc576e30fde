"""Three-lobe BSDF: diffuse reflection, specular reflection (GGX), and
specular transmission with dielectric Fresnel.

Reimplementation of the reference device BSDF
(/root/reference/Shaders/BxDF.hlsli:36-321): same lobe structure, lobe
probabilities (``ComputeLobeWeights``/``EstimateDiffuseProbability``),
sampling (``Sample``), per-lobe PDF (``EvaluatePDF``) and evaluation
(``Evaluate``) semantics — but fully vectorized and branch-free: every lane
computes all three lobes and selects by the sampled lobe id, the natural
formulation for array programs (no divergent control flow).

Conventions: V points away from the surface (toward the previous vertex);
L is the sampled outgoing direction; all directions are world-space unit
vectors of shape (..., 3). Evaluations include the NoL cosine factor, as in
the reference, so ``throughput *= eval / pdf``.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from ..utils import math as m
from . import brdf

MIN_ROUGHNESS = 2e-3  # BxDF.hlsli:19

LOBE_DIFFUSE = 0
LOBE_SPECULAR = 1
LOBE_TRANSMISSION = 2


@struct.dataclass
class BSDF:
    """Per-lane BSDF parameters (BxDF.hlsli BSDFSample::Initialize)."""
    base_color: jnp.ndarray   # (..., 3)
    metallic: jnp.ndarray     # (...,)
    albedo: jnp.ndarray       # (..., 3) = base_color * (1 - metallic)
    roughness: jnp.ndarray    # (...,) clamped to MIN_ROUGHNESS
    ior_i: jnp.ndarray        # (...,) incident-side IOR
    ior_o: jnp.ndarray        # (...,) transmitted-side IOR
    f0: jnp.ndarray           # (..., 3)
    transmission: jnp.ndarray  # (...,)


@struct.dataclass
class SurfaceVectors:
    """Shading frame (Shaders/SurfaceVectors.hlsli): the front-facing
    geometric normal plus the (possibly back-flipped) shading normal and its
    tangent basis."""
    front_geometric_normal: jnp.ndarray  # (..., 3)
    shading_normal: jnp.ndarray          # (..., 3)
    tangent: jnp.ndarray                 # (..., 3)
    bitangent: jnp.ndarray               # (..., 3)


def make_surface_vectors(is_front_face, geometric_normal, shading_normal):
    front_geom = jnp.where(is_front_face[..., None],
                           geometric_normal, -geometric_normal)
    t, b = m.orthonormal_basis(shading_normal)
    return SurfaceVectors(front_geometric_normal=front_geom,
                          shading_normal=shading_normal,
                          tangent=t, bitangent=b)


def make_bsdf(base_color, metallic, roughness, ior, transmission,
              is_front_face) -> BSDF:
    """BSDFSample::Initialize (BxDF.hlsli:45-67)."""
    base_color = base_color[..., :3]
    ior_i = jnp.where(is_front_face, 1.0, ior)
    ior_o = jnp.where(is_front_face, ior, 1.0)
    f_dielectric = m.sqr((ior_i - ior_o) / (ior_i + ior_o))
    f0 = m.lerp(f_dielectric[..., None], base_color, metallic[..., None])
    return BSDF(
        base_color=base_color,
        metallic=metallic,
        albedo=base_color * (1.0 - metallic[..., None]),
        roughness=jnp.maximum(roughness, MIN_ROUGHNESS),
        ior_i=ior_i, ior_o=ior_o, f0=f0,
        transmission=transmission,
    )


def estimate_diffuse_probability(albedo, f0, roughness, nov):
    """BxDF.hlsli:21-34. Returns 0 or 1 exactly at the degenerate ends,
    otherwise clamped to [0.05, 0.95]."""
    f_env = brdf.environment_term_rtg(f0, nov, roughness)
    diffuse = m.luminance(albedo * (1.0 - f_env))
    specular = m.luminance(f_env)
    total = diffuse + specular
    prob = jnp.where(total > 0, diffuse / jnp.maximum(total, 1e-20), 1.0)
    interior = (prob > 0.0) & (prob < 1.0)
    return jnp.where(interior, jnp.clip(prob, 0.05, 0.95), prob)


def lobe_weights(bsdf: BSDF, sv: SurfaceVectors, v):
    """(..., 3) sampling/mixture weights (BxDF.hlsli:184-196)."""
    nov = jnp.abs(m.dot(sv.shading_normal, v))
    tw = bsdf.transmission * (1.0 - bsdf.metallic)
    rw = 1.0 - tw
    dp = estimate_diffuse_probability(bsdf.albedo, bsdf.f0, bsdf.roughness,
                                      nov)
    return jnp.stack([dp * rw, (1.0 - dp) * rw, tw], axis=-1)


def _find_lobe(weights, u):
    """FindLobe (BxDF.hlsli:198-212): walk lobes from the last down,
    accumulating weight; pick the first whose cumulative weight exceeds u;
    fall through to lobe 0."""
    w_trans = weights[..., LOBE_TRANSMISSION]
    w_spec = weights[..., LOBE_SPECULAR]
    lobe = jnp.where(u < w_trans, LOBE_TRANSMISSION,
                     jnp.where(u < w_trans + w_spec, LOBE_SPECULAR,
                               LOBE_DIFFUSE))
    return lobe


def sample(bsdf: BSDF, sv: SurfaceVectors, v, rand4):
    """BSDFSample::Sample (BxDF.hlsli:214-226), branch-free.

    rand4: (..., 4) uniforms — [lobe select, dir u1, dir u2, fresnel].
    Returns (L, lobe_id, valid) where valid mirrors the reference's
    bool return (front-hemisphere checks for the reflection lobes).
    """
    t, b, n = sv.tangent, sv.bitangent, sv.shading_normal
    lobe = _find_lobe(lobe_weights(bsdf, sv, v), rand4[..., 0])
    v_local = m.to_local(t, b, n, v)

    # Diffuse: cosine hemisphere around the shading normal.
    l_diff = m.to_world(t, b, n, brdf.sample_cosine_hemisphere(rand4[..., 1:3]))

    # Specular reflection: VNDF half-vector, reflect.
    h_local = brdf.sample_vndf_ggx(rand4[..., 1:3], bsdf.roughness, v_local)
    h_world = m.to_world(t, b, n, h_local)
    l_spec = m.reflect(-v, h_world)

    # Transmission: same half-vector; Fresnel decides reflect vs refract
    # (BxDF.hlsli:148-168).
    eta = bsdf.ior_i / bsdf.ior_o
    voh = jnp.abs(m.dot(v, h_world))
    tir = eta * eta * (1.0 - voh * voh) > 1.0
    f_d = brdf.fresnel_dielectric(eta, voh)
    refracted, refr_tir = m.refract(-v, h_world, eta)
    refr_bad = refr_tir | (m.dot(refracted, refracted) < 1e-12)
    refracted = jnp.where(refr_bad[..., None], -v, refracted)
    reflect_mask = tir | (rand4[..., 3] < f_d)
    l_trans = jnp.where(reflect_mask[..., None], l_spec, refracted)

    l_out = jnp.where((lobe == LOBE_DIFFUSE)[..., None], l_diff,
                      jnp.where((lobe == LOBE_SPECULAR)[..., None],
                                l_spec, l_trans))
    front = m.dot(sv.front_geometric_normal, l_out) > 0
    valid = jnp.where(lobe == LOBE_TRANSMISSION, True, front)
    return l_out, lobe, valid


def _half_vector(bsdf: BSDF, sv: SurfaceVectors, l, v, is_transmissive):
    """ComputeHalfVector (BxDF.hlsli:228-245)."""
    n = sv.front_geometric_normal
    h_refl = m.normalize(l + v)
    h_refr = m.normalize(l * bsdf.ior_o[..., None] + v * bsdf.ior_i[..., None])
    h_refr = jnp.where(m.dot(n, h_refr)[..., None] < 0, -h_refr, h_refr)
    use_refr = is_transmissive & (m.dot(n, l) < 0)
    return jnp.where(use_refr[..., None], h_refr, h_refl)


def _lobe_pdfs(bsdf: BSDF, sv: SurfaceVectors, l, v, h):
    """Per-lobe PDFs, *without* lobe weights. Returns (..., 3)."""
    n = sv.shading_normal
    nol = jnp.abs(m.dot(n, l))
    noh = jnp.abs(m.dot(n, h))
    front = m.dot(sv.front_geometric_normal, l) > 0
    v_local_z = jnp.abs(m.dot(n, v))
    pdf_diff = jnp.where(front, brdf.pdf_cosine_hemisphere(nol), 0.0)
    pdf_spec = jnp.where(front, brdf.pdf_vndf_ggx(bsdf.roughness, noh,
                                                  v_local_z), 0.0)
    pdf_trans = nol  # BxDF.hlsli:170-175
    return jnp.stack([pdf_diff, pdf_spec, pdf_trans], axis=-1)


def _lobe_evals(bsdf: BSDF, sv: SurfaceVectors, l, v, h, weights):
    """Per-lobe evaluations including reflection/transmission energy split
    (but not the sampling probabilities). Returns (..., 3 lobes, 3 rgb)."""
    n = sv.shading_normal
    nol = jnp.abs(m.dot(n, l))
    nov = jnp.abs(m.dot(n, v))
    voh = jnp.abs(m.dot(v, h))
    noh = jnp.abs(m.dot(n, h))
    front = (m.dot(sv.front_geometric_normal, l) > 0)[..., None]
    tw = weights[..., LOBE_TRANSMISSION]
    rw = (1.0 - tw)[..., None]

    f_diff = nol[..., None] * bsdf.albedo * brdf.diffuse_term_burley(
        bsdf.roughness, nol, nov, voh)[..., None]
    f_diff = jnp.where(front, f_diff, 0.0) * rw

    d = brdf.distribution_ggx(bsdf.roughness, noh)
    vis = brdf.geometry_term_mod(bsdf.roughness, nol, nov)
    fr = brdf.fresnel_schlick(bsdf.f0, voh)
    f_spec = (nol * d * vis)[..., None] * fr
    f_spec = jnp.where(front, f_spec, 0.0) * rw

    f_trans = nol[..., None] * bsdf.base_color * tw[..., None]
    return jnp.stack([f_diff, f_spec, f_trans], axis=-2)


def _select_lobe(stacked, lobe, axis):
    """Elementwise 3-way select along a lobe axis instead of a narrow
    take_along_axis gather."""
    d = _take(stacked, LOBE_DIFFUSE, axis)
    s = _take(stacked, LOBE_SPECULAR, axis)
    t = _take(stacked, LOBE_TRANSMISSION, axis)
    while lobe.ndim < d.ndim:
        lobe = lobe[..., None]
    return jnp.where(lobe == LOBE_DIFFUSE, d,
                     jnp.where(lobe == LOBE_SPECULAR, s, t))


def _take(x, i, axis):
    sl = [slice(None)] * x.ndim
    sl[axis] = i
    return x[tuple(sl)]


def eval_pdf_lobe(bsdf, sv, l, v, weights, lobe):
    """EvaluatePDF for the sampled lobe × its weight (BxDF.hlsli:287-299)."""
    is_trans = weights[..., LOBE_TRANSMISSION] > 0
    h = _half_vector(bsdf, sv, l, v, is_trans)
    pdfs = _lobe_pdfs(bsdf, sv, l, v, h)
    lobe_w = _select_lobe(weights, lobe, axis=-1)
    pdf = _select_lobe(pdfs, lobe, axis=-1)
    return pdf * lobe_w


def eval_lobe(bsdf, sv, l, v, weights, lobe):
    """Evaluate for the sampled lobe (BxDF.hlsli:301-315)."""
    is_trans = weights[..., LOBE_TRANSMISSION] > 0
    h = _half_vector(bsdf, sv, l, v, is_trans)
    evals = _lobe_evals(bsdf, sv, l, v, h, weights)
    return _select_lobe(evals, lobe, axis=-2)


def eval_pdf(bsdf, sv, l, v, weights):
    """Combined mixture PDF over all lobes (BxDF.hlsli:247-264) — for MIS
    and ReSTIR target functions."""
    is_trans = weights[..., LOBE_TRANSMISSION] > 0
    h = _half_vector(bsdf, sv, l, v, is_trans)
    pdfs = _lobe_pdfs(bsdf, sv, l, v, h)
    return jnp.sum(pdfs * weights, axis=-1)


def eval_split(bsdf, sv, l, v, weights):
    """(diffuse, specular) full-BSDF split (BxDF.hlsli:266-285) — the
    contract the denoiser and ReSTIR final shading rely on."""
    is_trans = weights[..., LOBE_TRANSMISSION] > 0
    h = _half_vector(bsdf, sv, l, v, is_trans)
    evals = _lobe_evals(bsdf, sv, l, v, h, weights)
    diffuse = evals[..., LOBE_DIFFUSE, :]
    specular = evals[..., LOBE_SPECULAR, :] + evals[..., LOBE_TRANSMISSION, :]
    return diffuse, specular


def demodulation_factors(bsdf: BSDF, sv: SurfaceVectors, v):
    """NRD-style demodulation albedos (BxDF.hlsli:317-320 /
    NRD_MaterialFactors): diffuse = albedo, specular = preintegrated env
    term — used by the G-buffer and denoiser composition passes."""
    nov = jnp.abs(m.dot(sv.shading_normal, v))
    f_env = brdf.environment_term_rtg(bsdf.f0, nov, bsdf.roughness)
    return bsdf.albedo * (1.0 - f_env), f_env
