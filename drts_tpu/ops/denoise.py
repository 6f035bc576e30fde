"""NRD-analogue denoisers: ReBLUR-style and ReLAX-style modes.

Replacement for the NRD library integration (SURVEY.md §2.3 "NRD"
row; host wrapper /root/reference/Source/NRD.ixx, composition passes
/root/reference/Shaders/NRDComposition.hlsl): the same data contract —
demodulated diffuse and specular radiance+hitdist channels in, denoised
radiance out, composed as ``diffuse*albedo + specular*f_env + direct``
(NRDComposition.hlsl:71-87) — with the denoising cores rebuilt as pure JAX.

Two selectable modes, matching the reference's two NRD denoisers
(App.cpp:456 creates both REBLUR_DIFFUSE_SPECULAR and
RELAX_DIFFUSE_SPECULAR; the active one is a runtime setting):

* ``denoise`` — ReBLUR-style: exponential accumulation with per-pixel
  history length, hit-distance/edge-guided à-trous, history-convergence
  fade.
* ``denoise_relax`` — ReLAX-style (SVGF lineage): temporal accumulation of
  luminance *moments*, per-pixel variance estimation, variance-guided
  à-trous weights with variance propagation (w² filtering), and firefly
  suppression. Distinct tuning: more aggressive spatial filtering while
  variance is high, less reliance on history fade.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from ..utils import struct

from ..utils import math as m
from .reproject import reproject


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    max_accumulated_frames: int = 30   # ReBLUR-style cap
    atrous_iterations: int = 3
    depth_threshold: float = 0.05      # relative depth disocclusion test
    normal_threshold: float = 0.9      # cos angle for history validity
    sigma_luminance: float = 4.0
    specular_hitdist_scale: float = 1.0
    # History reprojection filter: "nearest" costs 1 random row-read per
    # pixel, "bilinear" 4.
    history_filter: str = "nearest"
    # Variance-guided history clamp (ReLAX anti-lag analogue): reprojected
    # history is clamped to mean +- gamma*sigma of the CURRENT frame's 3x3
    # neighborhood, so stale shading that slipped past the geometric
    # disocclusion tests (same depth plane, slow normals) cannot ghost.
    # 1-spp neighborhoods are noisy, so sigma is wide and converged
    # history passes untouched. 0 disables.
    clamp_gamma: float = 2.5
    # Specular virtual-point reprojection (NRD ReBLUR's specular motion
    # model): reflections move with the VIRTUAL image behind the mirror
    # (surface + view * hitDist), not with the surface. The specular
    # history is fetched from its own packed mirror at that motion when
    # the caller provides `motion_specular`.
    specular_virtual: bool = True
    # ReLAX-mode tuning (NRD RelaxSettings analogues).
    relax_atrous_iterations: int = 4
    relax_sigma_luminance: float = 3.0   # in units of sqrt(variance)
    relax_firefly: bool = True           # enableAntiFirefly
    relax_firefly_factor: float = 8.0    # clamp at N x neighborhood mean


# Finite stand-in for miss-pixel depth: the G-buffer reports inf on miss
# (GBufferGeneration depth channel); inf - inf = NaN would flood the
# spatial-filter footprint, so all filter math uses this clamp.
_FAR_DEPTH = 1e8


@struct.dataclass
class DenoiserState:
    """History buffers (the reference's ping-pong texture pairs,
    App.cpp:618-625, held functionally). ``moments`` carries the ReLAX-mode
    luminance moments [diff_mu1, diff_mu2, spec_mu1, spec_mu2]; the ReBLUR
    path leaves it untouched."""
    diffuse: jnp.ndarray        # (H, W, 4) rgb + hitdist
    specular: jnp.ndarray      # (H, W, 4)
    history_length: jnp.ndarray  # (H, W)
    normal: jnp.ndarray         # (H, W, 3) previous shading normal
    depth: jnp.ndarray          # (H, W) previous linear depth
    moments: jnp.ndarray        # (H, W, 4) ReLAX luminance moments
    # (H, W, 8) f16-pair-packed fetch mirror (the RGBA16F history-texture
    # layout NRD itself uses): [diff.rg, diff.b|hd, spec.rg, spec.b|hd,
    # hist|depth, oct normal, mom d1|d2, mom s1|s2]: one 32-byte row per
    # pixel for the nearest history fetch. Depth in f16 (5e-4 rel) is far
    # inside the 0.1 relative disocclusion threshold; history length
    # <= 64 is f16-exact.
    packed: jnp.ndarray
    # (H, W, 2) f16-pair specular-only mirror [s.rg, s.b|hd] — the virtual-
    # point reprojection fetches specular at a DIFFERENT screen position
    # than the surface channels, so it needs its own (narrow) source.
    packed_spec: jnp.ndarray


def _pack_history(diffuse, specular, hist, normal, depth, moments):
    return jnp.stack([
        m.pack2f16(diffuse[..., 0], diffuse[..., 1]),
        m.pack2f16(diffuse[..., 2], diffuse[..., 3]),
        m.pack2f16(specular[..., 0], specular[..., 1]),
        m.pack2f16(specular[..., 2], specular[..., 3]),
        m.pack2f16(hist, jnp.minimum(depth, 3e4)),
        m.pack_oct16(normal),
        m.pack2f16(moments[..., 0], moments[..., 1]),
        m.pack2f16(moments[..., 2], moments[..., 3]),
    ], axis=-1)


def _pack_spec(specular):
    return jnp.stack([
        m.pack2f16(specular[..., 0], specular[..., 1]),
        m.pack2f16(specular[..., 2], specular[..., 3]),
    ], axis=-1)


def _unpack_spec(p):
    s0, s1 = m.unpack2f16(p[..., 0])
    s2, s3 = m.unpack2f16(p[..., 1])
    return jnp.stack([s0, s1, s2, s3], axis=-1)


def _unpack_history(prev):
    d0, d1 = m.unpack2f16(prev[..., 0])
    d2, d3 = m.unpack2f16(prev[..., 1])
    s0, s1 = m.unpack2f16(prev[..., 2])
    s2, s3 = m.unpack2f16(prev[..., 3])
    hist, depth = m.unpack2f16(prev[..., 4])
    m0, m1_ = m.unpack2f16(prev[..., 6])
    m2, m3 = m.unpack2f16(prev[..., 7])
    return (jnp.stack([d0, d1, d2, d3], axis=-1),
            jnp.stack([s0, s1, s2, s3], axis=-1),
            hist,
            m.unpack_oct16(prev[..., 5]),
            depth,
            jnp.stack([m0, m1_, m2, m3], axis=-1))


def init_state(height: int, width: int) -> DenoiserState:
    """Fresh history (the m_resetHistory path, App.cpp:667-679)."""
    zero4 = jnp.zeros((height, width, 4), jnp.float32)
    zero1 = jnp.zeros((height, width), jnp.float32)
    far = jnp.full((height, width), _FAR_DEPTH, jnp.float32)
    up = jnp.zeros((height, width, 3), jnp.float32).at[..., 2].set(1.0)
    return DenoiserState(
        diffuse=zero4, specular=zero4,
        history_length=zero1,
        normal=jnp.zeros((height, width, 3), jnp.float32),
        depth=far,
        moments=zero4,
        packed=_pack_history(zero4, zero4, zero1, up, far, zero4),
        packed_spec=_pack_spec(zero4))


def _shift(img, dy: int, dx: int):
    """Clamp-addressed neighborhood shift via edge-pad + static slice —
    the a-trous chain takes 100+ taps, and pad+slice is a plain copy XLA
    fuses where an index-vector gather would not be."""
    h, w = img.shape[0], img.shape[1]
    pads = ((max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0)))
    pads = pads + ((0, 0),) * (img.ndim - 2)
    p = jnp.pad(img, pads, mode="edge")
    return p[max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w]


def _shift_chw(img, dy: int, dx: int):
    """Edge-clamped shift on the trailing (H, W) axes of a (C, H, W)
    stack."""
    h, w = img.shape[-2], img.shape[-1]
    pads = ((0, 0),) * (img.ndim - 2) + (
        (max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0)))
    p = jnp.pad(img, pads, mode="edge")
    return p[..., max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w]


_LUMA_W = (0.2126, 0.7152, 0.0722)


def _neighborhood_clamp(prev, cur, gamma: float):
    """Clamp reprojected history to the current frame's 3x3 per-channel
    mean +- gamma*sigma (the TAA variance-clip applied to denoiser
    history — NRD ReLAX's history clamping). gamma <= 0 disables."""
    if gamma <= 0.0:
        return prev
    m1 = jnp.zeros_like(cur)
    m2 = jnp.zeros_like(cur)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(cur, dy, dx)
            m1 = m1 + s
            m2 = m2 + s * s
    mean = m1 / 9.0
    sigma = jnp.sqrt(jnp.maximum(m2 / 9.0 - mean * mean, 0.0)) * gamma
    return jnp.clip(prev, mean - sigma, mean + sigma)


def virtual_specular_motion(surface_motion, hit_position, ray_direction,
                            hit_distance, prev_px_of):
    """Specular motion vectors from the VIRTUAL reflection point
    Xv = X + view * hitDist (NRD ReBLUR's specular motion model): mirror
    reflections translate with the virtual image behind the surface, not
    with the surface itself. ``prev_px_of`` maps world positions to
    previous-frame pixel coordinates (the caller closes over its camera);
    lanes with no secondary hit (env reflections) keep the surface
    motion."""
    hd = jnp.where(jnp.isfinite(hit_distance), hit_distance, 0.0)
    xv = hit_position + ray_direction * jnp.minimum(hd, 3e4)[..., None]
    prev_px, cur_px = prev_px_of(xv)
    motion_v = prev_px - cur_px
    has_hit = jnp.isfinite(hit_distance) & (hit_distance > 0)
    return jnp.where(has_hit[..., None], motion_v, surface_motion)


def _atrous_pass_chw(signal, normal, depth, step: int, cfg: DenoiseConfig):
    """One edge-stopping à-trous iteration, channel-FIRST (C, H, W).

    With (C, H, W) each channel is a contiguous plane, so every shifted
    tap is a plain strided copy. Edge-stopping falloffs are rational
    (1/(1+x)), not exp, for transcendental-free taps.
    """
    kernel = ((0, 0, 0.25), (-1, 0, 0.125), (1, 0, 0.125), (0, -1, 0.125),
              (0, 1, 0.125), (-1, -1, 0.0625), (-1, 1, 0.0625),
              (1, -1, 0.0625), (1, 1, 0.0625))
    lum_c = (_LUMA_W[0] * signal[0] + _LUMA_W[1] * signal[1]
             + _LUMA_W[2] * signal[2])
    inv_depth_sigma = 1.0 / jnp.maximum(
        cfg.depth_threshold * jnp.abs(depth), 1e-4)
    acc = jnp.zeros_like(signal)
    wsum = jnp.zeros(signal.shape[-2:], jnp.float32)
    for dy, dx, wk in kernel:
        s = _shift_chw(signal, dy * step, dx * step)
        n = _shift_chw(normal, dy * step, dx * step)
        d = _shift_chw(depth, dy * step, dx * step)
        ndot = n[0] * normal[0] + n[1] * normal[1] + n[2] * normal[2]
        w_n = jnp.maximum(ndot, 0.0) ** 32
        w_d = 1.0 / (1.0 + jnp.abs(d - depth) * inv_depth_sigma)
        lum_s = (_LUMA_W[0] * s[0] + _LUMA_W[1] * s[1] + _LUMA_W[2] * s[2])
        w_l = 1.0 / (1.0 + jnp.abs(lum_s - lum_c) / cfg.sigma_luminance)
        w = wk * w_n * w_d * w_l
        acc = acc + s * w[None]
        wsum = wsum + w
    return acc / jnp.maximum(wsum, 1e-8)[None]


def denoise(state: DenoiserState, diffuse, specular, motion, normal, depth,
            valid, roughness, reset, cfg: DenoiseConfig = DenoiseConfig(),
            motion_specular=None):
    """Temporal accumulation + spatial filtering of the demodulated signals.

    diffuse/specular: (H, W, 4) rgb+hitdist (this frame, 1-spp noisy).
    motion: (H, W, 2) prev-pixel = current-pixel + motion (x, y in pixels).
    normal/depth/valid/roughness: current G-buffer attributes.
    reset: scalar bool — drop all history (App.cpp m_resetHistory).
    motion_specular: optional (H, W, 2) virtual-point motion for the
    specular channel (see virtual_specular_motion).
    Returns (new_state, filtered_diffuse, filtered_specular), each (H, W, 4).
    """
    depth = jnp.where(jnp.isfinite(depth), depth, _FAR_DEPTH)
    diffuse = jnp.nan_to_num(diffuse, nan=0.0, posinf=0.0, neginf=0.0)
    specular = jnp.nan_to_num(specular, nan=0.0, posinf=0.0, neginf=0.0)

    # One packed history fetch. Nearest mode reads the f16-packed mirror
    # (36 B/row); bilinear interpolation cannot run on packed bits, so
    # that mode falls back to the full-f32 concat.
    if cfg.history_filter == "nearest":
        prev, in_bounds = reproject(state.packed, motion, "nearest")
        (prev_diffuse, prev_specular, prev_hist, prev_normal, prev_depth,
         _prev_moments) = _unpack_history(prev)
    else:
        packed = jnp.concatenate(
            [state.diffuse, state.specular,
             state.history_length[..., None],
             state.normal, state.depth[..., None]], axis=-1)
        prev, in_bounds = reproject(packed, motion, cfg.history_filter)
        prev_diffuse = prev[..., 0:4]
        prev_specular = prev[..., 4:8]
        prev_hist = prev[..., 8]
        prev_normal = prev[..., 9:12]
        prev_depth = prev[..., 12]

    # Disocclusion tests (NRD common settings: depth + normal consistency).
    depth_ok = jnp.abs(prev_depth - depth) \
        <= cfg.depth_threshold * jnp.maximum(jnp.abs(depth), 1e-3)
    normal_ok = m.dot(prev_normal, normal) >= cfg.normal_threshold
    history_valid = in_bounds & depth_ok & normal_ok & valid & ~reset

    # Specular from the virtual-point mirror when virtual motion is given:
    # the reflection image does not move with the surface, so fetching it
    # at surface motion smears highlights under any camera motion. The
    # geometric disocclusion tests stay surface-based (conservative); the
    # neighborhood clamp below catches what they can't.
    spec_valid = history_valid
    if motion_specular is not None and cfg.specular_virtual:
        prev_spec_v, in_bounds_v = reproject(state.packed_spec,
                                              motion_specular, "nearest")
        prev_specular = _unpack_spec(prev_spec_v)
        spec_valid = in_bounds_v & normal_ok & valid & ~reset

    # Anti-ghosting history clamp (see DenoiseConfig.clamp_gamma).
    prev_diffuse = _neighborhood_clamp(prev_diffuse, diffuse,
                                       cfg.clamp_gamma)
    prev_specular = _neighborhood_clamp(prev_specular, specular,
                                        cfg.clamp_gamma)

    hist = jnp.where(history_valid, prev_hist, 0.0)
    new_hist = jnp.minimum(hist + 1.0, cfg.max_accumulated_frames)
    alpha = (1.0 / new_hist)[..., None]

    acc_diffuse = m.lerp(jnp.where(history_valid[..., None], prev_diffuse,
                                   0.0), diffuse, alpha)
    # Specular history is more fragile under motion: shorten it by roughness
    # (rough = stable, smooth = short history), ReBLUR-style. With virtual
    # reprojection the mirror-end history is trustworthy again, so the
    # shortening floor relaxes toward plain 1/N accumulation.
    lo = 0.35 if (motion_specular is not None
                  and cfg.specular_virtual) else 0.1
    spec_hist_scale = jnp.clip(roughness * 2.0, lo, 1.0)
    spec_alpha = jnp.maximum(alpha[..., 0], 1.0 - spec_hist_scale *
                             (1.0 - alpha[..., 0]))[..., None]
    spec_alpha = jnp.where(spec_valid[..., None], spec_alpha, 1.0)
    acc_specular = m.lerp(jnp.where(spec_valid[..., None], prev_specular,
                                    0.0), specular, spec_alpha)

    # Spatial à-trous passes over the accumulated signals, channel-first
    # (see _atrous_pass_chw for the layout rationale).
    normal_chw = jnp.moveaxis(normal, -1, 0)
    f_diffuse = jnp.moveaxis(acc_diffuse, -1, 0)
    f_specular = jnp.moveaxis(acc_specular, -1, 0)
    for i in range(cfg.atrous_iterations):
        step = 1 << i
        f_diffuse = _atrous_pass_chw(f_diffuse, normal_chw, depth, step,
                                     cfg)
        f_specular = _atrous_pass_chw(f_specular, normal_chw, depth, step,
                                      cfg)
    f_diffuse = jnp.moveaxis(f_diffuse, 0, -1)
    f_specular = jnp.moveaxis(f_specular, 0, -1)

    # ReBLUR-style convergence fade: young pixels need the full spatial
    # kernel; converged history needs none (blurring a converged signal
    # only destroys detail). Specular additionally scales with roughness —
    # mirror reflections (roughness ~0) must not be spatially filtered.
    hist_blend = jnp.clip(4.0 / new_hist, 0.0, 1.0)[..., None]
    spec_blend = hist_blend * jnp.clip(roughness * 4.0, 0.1, 1.0)[..., None]
    f_diffuse = m.lerp(acc_diffuse, f_diffuse, hist_blend)
    f_specular = m.lerp(acc_specular, f_specular, spec_blend)

    new_state = DenoiserState(diffuse=acc_diffuse, specular=acc_specular,
                              history_length=new_hist, normal=normal,
                              depth=depth, moments=state.moments,
                              packed=_pack_history(acc_diffuse,
                                                   acc_specular, new_hist,
                                                   normal, depth,
                                                   state.moments),
                              packed_spec=_pack_spec(acc_specular))
    return new_state, f_diffuse, f_specular


def _firefly_suppress(signal, factor: float):
    """ReLAX anti-firefly (enableAntiFirefly): clamp pixels whose luminance
    exceeds ``factor`` x the 3x3 neighbor mean. Shift-based — no gathers."""
    rgb = signal[..., :3]
    lum = (_LUMA_W[0] * rgb[..., 0] + _LUMA_W[1] * rgb[..., 1]
           + _LUMA_W[2] * rgb[..., 2])
    nsum = jnp.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nsum = nsum + _shift(lum[..., None], dy, dx)[..., 0]
    nmean = nsum / 8.0
    limit = factor * nmean + 1e-3
    scale = jnp.where(lum > limit, limit / jnp.maximum(lum, 1e-6), 1.0)
    return jnp.concatenate([rgb * scale[..., None], signal[..., 3:]],
                           axis=-1)


def _atrous_relax_chw(signal, var, normal, depth, step: int,
                      cfg: DenoiseConfig):
    """One variance-guided à-trous iteration (the SVGF/ReLAX core),
    channel-first. Luminance edge-stopping is scaled by the local noise
    estimate sqrt(var); variance propagates through the filter with w²
    weights so later iterations relax as the signal converges."""
    kernel = ((0, 0, 0.25), (-1, 0, 0.125), (1, 0, 0.125), (0, -1, 0.125),
              (0, 1, 0.125), (-1, -1, 0.0625), (-1, 1, 0.0625),
              (1, -1, 0.0625), (1, 1, 0.0625))
    lum_c = (_LUMA_W[0] * signal[0] + _LUMA_W[1] * signal[1]
             + _LUMA_W[2] * signal[2])
    # 3x3-prefiltered variance for the sigma estimate (SVGF does a gaussian
    # prefilter of the variance before using it in the weight).
    vsum = var
    for dy, dx, wk in kernel[1:]:
        vsum = vsum + _shift_chw(var, dy, dx)
    sigma = jnp.sqrt(jnp.maximum(vsum / 9.0, 0.0))
    inv_sigma_l = 1.0 / (cfg.relax_sigma_luminance * sigma + 1e-4)
    inv_depth_sigma = 1.0 / jnp.maximum(
        cfg.depth_threshold * jnp.abs(depth), 1e-4)
    acc = jnp.zeros_like(signal)
    acc_var = jnp.zeros_like(var)
    wsum = jnp.zeros(var.shape, jnp.float32)
    for dy, dx, wk in kernel:
        s = _shift_chw(signal, dy * step, dx * step)
        v = _shift_chw(var, dy * step, dx * step)
        n = _shift_chw(normal, dy * step, dx * step)
        d = _shift_chw(depth, dy * step, dx * step)
        ndot = n[0] * normal[0] + n[1] * normal[1] + n[2] * normal[2]
        w_n = jnp.maximum(ndot, 0.0) ** 32
        w_d = 1.0 / (1.0 + jnp.abs(d - depth) * inv_depth_sigma)
        lum_s = (_LUMA_W[0] * s[0] + _LUMA_W[1] * s[1] + _LUMA_W[2] * s[2])
        w_l = 1.0 / (1.0 + jnp.abs(lum_s - lum_c) * inv_sigma_l)
        w = wk * w_n * w_d * w_l
        acc = acc + s * w[None]
        acc_var = acc_var + v * w * w
        wsum = wsum + w
    wsum = jnp.maximum(wsum, 1e-8)
    return acc / wsum[None], acc_var / (wsum * wsum)


def denoise_relax(state: DenoiserState, diffuse, specular, motion, normal,
                  depth, valid, roughness, reset,
                  cfg: DenoiseConfig = DenoiseConfig(),
                  motion_specular=None):
    """ReLAX-style denoise: moment accumulation + variance-guided à-trous.

    Same I/O contract as ``denoise`` (the reference swaps NRD denoisers
    behind one integration, App.cpp:1628-1636). Differences: per-pixel
    luminance variance drives the spatial filter instead of a fixed sigma,
    variance is propagated through the filter (w²), young pixels fall back
    to a spatial variance estimate, and fireflies are clamped up front.
    """
    depth = jnp.where(jnp.isfinite(depth), depth, _FAR_DEPTH)
    diffuse = jnp.nan_to_num(diffuse, nan=0.0, posinf=0.0, neginf=0.0)
    specular = jnp.nan_to_num(specular, nan=0.0, posinf=0.0, neginf=0.0)
    if cfg.relax_firefly:
        diffuse = _firefly_suppress(diffuse, cfg.relax_firefly_factor)
        specular = _firefly_suppress(specular, cfg.relax_firefly_factor)

    lum_d = (_LUMA_W[0] * diffuse[..., 0] + _LUMA_W[1] * diffuse[..., 1]
             + _LUMA_W[2] * diffuse[..., 2])
    lum_s = (_LUMA_W[0] * specular[..., 0] + _LUMA_W[1] * specular[..., 1]
             + _LUMA_W[2] * specular[..., 2])
    cur_moments = jnp.stack([lum_d, lum_d * lum_d, lum_s, lum_s * lum_s],
                            axis=-1)

    # Packed history fetch (diffuse, specular, hist, normal, depth,
    # moments) — f16-packed mirror in nearest mode (see DenoiserState).
    if cfg.history_filter == "nearest":
        prev, in_bounds = reproject(state.packed, motion, "nearest")
        (prev_diffuse, prev_specular, prev_hist, prev_normal, prev_depth,
         prev_moments) = _unpack_history(prev)
    else:
        packed = jnp.concatenate(
            [state.diffuse, state.specular,
             state.history_length[..., None],
             state.normal, state.depth[..., None], state.moments], axis=-1)
        prev, in_bounds = reproject(packed, motion, cfg.history_filter)
        prev_diffuse = prev[..., 0:4]
        prev_specular = prev[..., 4:8]
        prev_hist = prev[..., 8]
        prev_normal = prev[..., 9:12]
        prev_depth = prev[..., 12]
        prev_moments = prev[..., 13:17]

    depth_ok = jnp.abs(prev_depth - depth) \
        <= cfg.depth_threshold * jnp.maximum(jnp.abs(depth), 1e-3)
    normal_ok = m.dot(prev_normal, normal) >= cfg.normal_threshold
    history_valid = in_bounds & depth_ok & normal_ok & valid & ~reset

    # Virtual-point specular fetch + anti-ghosting clamp (see `denoise`).
    spec_valid = history_valid
    if motion_specular is not None and cfg.specular_virtual:
        prev_spec_v, in_bounds_v = reproject(state.packed_spec,
                                              motion_specular, "nearest")
        prev_specular = _unpack_spec(prev_spec_v)
        spec_valid = in_bounds_v & normal_ok & valid & ~reset
    prev_diffuse = _neighborhood_clamp(prev_diffuse, diffuse,
                                       cfg.clamp_gamma)
    prev_specular = _neighborhood_clamp(prev_specular, specular,
                                        cfg.clamp_gamma)

    hist = jnp.where(history_valid, prev_hist, 0.0)
    new_hist = jnp.minimum(hist + 1.0, cfg.max_accumulated_frames)
    alpha = (1.0 / new_hist)[..., None]

    hv = history_valid[..., None]
    sv = spec_valid[..., None]
    spec_alpha = jnp.where(sv, alpha, 1.0)
    acc_diffuse = m.lerp(jnp.where(hv, prev_diffuse, 0.0), diffuse, alpha)
    acc_specular = m.lerp(jnp.where(sv, prev_specular, 0.0), specular,
                          spec_alpha)
    acc_moments = m.lerp(jnp.where(hv, prev_moments, 0.0), cur_moments,
                         alpha)

    var_d = jnp.maximum(acc_moments[..., 1] - acc_moments[..., 0] ** 2, 0.0)
    var_s = jnp.maximum(acc_moments[..., 3] - acc_moments[..., 2] ** 2, 0.0)
    # Young history -> temporal variance unreliable; fall back to a 3x3
    # spatial estimate of the current frame's moments (SVGF's fallback).
    sp_d1 = sp_d2 = sp_s1 = sp_s2 = jnp.zeros_like(lum_d)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ld = _shift(lum_d[..., None], dy, dx)[..., 0]
            ls = _shift(lum_s[..., None], dy, dx)[..., 0]
            sp_d1 += ld
            sp_d2 += ld * ld
            sp_s1 += ls
            sp_s2 += ls * ls
    sp_var_d = jnp.maximum(sp_d2 / 9.0 - (sp_d1 / 9.0) ** 2, 0.0)
    sp_var_s = jnp.maximum(sp_s2 / 9.0 - (sp_s1 / 9.0) ** 2, 0.0)
    young = new_hist < 4.0
    var_d = jnp.where(young, jnp.maximum(var_d, sp_var_d), var_d)
    var_s = jnp.where(young, jnp.maximum(var_s, sp_var_s), var_s)

    normal_chw = jnp.moveaxis(normal, -1, 0)
    f_diffuse = jnp.moveaxis(acc_diffuse, -1, 0)
    f_specular = jnp.moveaxis(acc_specular, -1, 0)
    for i in range(cfg.relax_atrous_iterations):
        step = 1 << i
        f_diffuse, var_d = _atrous_relax_chw(f_diffuse, var_d, normal_chw,
                                             depth, step, cfg)
        f_specular, var_s = _atrous_relax_chw(f_specular, var_s, normal_chw,
                                              depth, step, cfg)
    f_diffuse = jnp.moveaxis(f_diffuse, 0, -1)
    f_specular = jnp.moveaxis(f_specular, 0, -1)

    # Mirror-like specular must stay unfiltered (same rationale as ReBLUR
    # path); diffuse keeps the full variance-guided result — the variance
    # weights already collapse the kernel once converged.
    spec_keep = jnp.clip(roughness * 4.0, 0.1, 1.0)[..., None]
    f_specular = m.lerp(acc_specular, f_specular, spec_keep)

    new_state = DenoiserState(diffuse=acc_diffuse, specular=acc_specular,
                              history_length=new_hist, normal=normal,
                              depth=depth, moments=acc_moments,
                              packed=_pack_history(acc_diffuse,
                                                   acc_specular, new_hist,
                                                   normal, depth,
                                                   acc_moments),
                              packed_spec=_pack_spec(acc_specular))
    return new_state, f_diffuse, f_specular


def compose(gbuf_radiance, f_diffuse, f_specular, diffuse_albedo,
            specular_albedo, valid):
    """NRDComposition unpack (NRDComposition.hlsl:71-87): remodulate and add
    the primary emission/environment radiance."""
    out = (f_diffuse[..., :3] * diffuse_albedo
           + f_specular[..., :3] * specular_albedo)
    return jnp.where(valid[..., None], gbuf_radiance + out, gbuf_radiance)


def demodulate(radiance_diffuse, radiance_specular, diffuse_albedo,
               specular_albedo, eps: float = 1e-3):
    """NRDComposition pack (NRDComposition.hlsl:50-70)."""
    return (radiance_diffuse / jnp.maximum(diffuse_albedo, eps),
            radiance_specular / jnp.maximum(specular_albedo, eps))
