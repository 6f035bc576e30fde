"""ReSTIR DI: ReGIR grid presampling + initial/temporal/spatial reservoir
resampling + final shading.

Reimplementation of the NVIDIA RTXDI integration (SURVEY.md §2.3
"RTXDI" row; host /root/reference/Source/RTXDI.ixx:141-241 dispatch chain,
device Shaders/{LocalLightPresampling,ReGIRPresampling,DIInitialSampling,
DITemporalResampling,DISpatialResampling,DIFinalShading}.hlsl and the RAB_*
callbacks in Shaders/RTXDIAppBridge.hlsli). Redesign notes:

- Reservoirs are SoA (H, W) arrays (light index, sample uv, w_sum, M, W) —
  the RTXDI reservoir buffer layout flattened into dense per-pixel planes.
- The ReGIR onion grid becomes a camera-centered uniform world grid of
  per-cell RIS reservoirs, built by one dense (cells × samples) pass.
- Power presampling (RIS tiles from the PDF-texture mips) becomes power-CDF
  inversion (see ops/light.py) — the same distribution as the reference's
  Z-curve PDF texture descent, in one vectorized searchsorted.
- Target function p_hat = luminance(BSDF(ω)·Le) in solid-angle measure,
  re-evaluated at each reuse site (the RAB_GetLightSampleTargetPdfForSurface
  contract); visibility enters at initial sampling and final shading
  (DIInitialSampling.hlsl:6-58, DIFinalShading.hlsl:77-103).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from ..utils import struct

from ..utils import math as m
from ..utils import rng as rng_mod
from ..models.scene import SphereScene
from . import bxdf, intersect, light as light_mod
from .reproject import reproject


@dataclasses.dataclass(frozen=True)
class ReSTIRConfig:
    """MyAppData.h:190-253 defaults."""
    regir_cells_per_axis: int = 16
    regir_cell_size: float = 1.0
    regir_slots_per_cell: int = 8
    regir_build_samples: int = 8
    # Local-light candidate source (ReSTIRDI_LocalLightSamplingMode,
    # MyAppData.h:35-39 / RTXDI.ixx:218): "ReGIR_RIS" draws from the
    # prebuilt grid (default; one packed prefetch per pixel), "Power_RIS"
    # draws fresh power-CDF samples per candidate (the presampled-tile
    # mode collapsed to direct inversion — more per-pixel CDF sweeps),
    # "Uniform" draws uniformly over the valid compact lights.
    local_light_mode: str = "ReGIR_RIS"
    local_light_samples: int = 8
    brdf_samples: int = 1
    temporal_enabled: bool = True
    spatial_enabled: bool = True
    max_history: int = 20
    boiling_filter_strength: float = 0.2
    spatial_samples: int = 1
    spatial_radius: float = 30.0
    depth_threshold: float = 0.1
    normal_threshold: float = 0.5
    # Spatial-reuse MIS mode (the RTXDI bias-correction switch,
    # /root/reference/Source/RTXDI.ixx:73-139 spatialBiasCorrection):
    #   "basic"     — 1/M normalization (cheapest; slight darkening bias at
    #                 geometric edges where neighbor target pdfs disagree),
    #   "pairwise"  — pairwise balance heuristic between each neighbor and
    #                 the canonical reservoir (unbiased; re-evaluates each
    #                 sample at BOTH surfaces),
    #   "raytraced" — pairwise with a visibility ray folded into the
    #                 cross-surface target pdfs (also corrects shadow-edge
    #                 bias; costs one any-hit batch per cross term).
    spatial_bias_correction: str = "basic"
    # Temporal-reuse MIS mode (the reference exposes the same
    # Basic/Pairwise/Raytraced switch for temporal resampling,
    # /root/reference/Source/MyAppData.h:226-239). The pairwise cross
    # terms need the PREVIOUS surface — see temporal_prev_surface.
    temporal_bias_correction: str = "basic"
    # How the pairwise/raytraced temporal modes reconstruct the previous
    # surface (RAB_GetGBufferSurface previousFrame=true,
    # RTXDIAppBridge.hlsli:293-348):
    #   "pseudo" — the current surface's BSDF with the reprojected
    #              previous shading normal (no extra state; the
    #              depth/normal history gates bound the error),
    #   "real"   — the previous frame's ACTUAL position + material rows,
    #              packed by pack_prev_material and reprojected alongside
    #              the reservoir rows (the reference's previous-G-buffer
    #              path; needs the pipeline to carry prev_surface_rows).
    temporal_prev_surface: str = "pseudo"
    # Spatial neighbor addressing. "per_pixel" draws an independent disc
    # offset per pixel per round (RTXDI's per-pixel start into the
    # neighbor-offset buffer) — each round is then a random row gather.
    # "shared" degenerates the reference's
    # precomputed low-discrepancy offset buffer
    # (Rtxdi FillNeighborOffsetBuffer) to ONE offset per round, rotated
    # per frame — every pixel borrows from the same relative neighbor, so
    # the fetch is a dynamic roll (streaming copy, no gather). Resampling
    # stays unbiased for ANY content-independent neighbor choice (the MIS
    # weights normalize the stream); the cost is cross-pixel error
    # correlation, which the rotation decorrelates over frames.
    spatial_offset_mode: str = "per_pixel"
    # Evaluate the local-light candidates as ONE batched (n_l, H, W)
    # target-pdf call instead of n_l sequential (H, W) calls. Bit-identical
    # results (same RNG draws, same reservoir update order) — only the
    # schedule changes: surface fields stream from HBM once for all
    # candidates and the one-hot row fetch becomes a single taller matmul.
    candidate_batch: bool = False


@struct.dataclass
class Reservoirs:
    """Per-pixel DI reservoirs (RTXDIResources.ixx:76 buffer analogue)."""
    light_index: jnp.ndarray  # (H, W) int32 COMPACT light id (light.Lights)
    uv: jnp.ndarray           # (H, W, 2) sample randoms (re-traced per site)
    w_sum: jnp.ndarray        # (H, W)
    m_count: jnp.ndarray      # (H, W)
    w_out: jnp.ndarray        # (H, W) unbiased contribution weight W
    # Target pdf of the selected sample AT THE SURFACE THAT OWNS THIS
    # RESERVOIR — carried so the next resampling stage (same pixel, same
    # frame) skips a full light-row gather + BSDF re-evaluation. Stale for
    # *reprojected/neighbor* fetches, which must re-evaluate (the
    # RAB_GetLightSampleTargetPdfForSurface contract).
    phat: jnp.ndarray         # (H, W)


def init_reservoirs(height: int, width: int) -> Reservoirs:
    return Reservoirs(
        light_index=jnp.zeros((height, width), jnp.int32),
        uv=jnp.zeros((height, width, 2), jnp.float32),
        w_sum=jnp.zeros((height, width), jnp.float32),
        m_count=jnp.zeros((height, width), jnp.float32),
        w_out=jnp.zeros((height, width), jnp.float32),
        phat=jnp.zeros((height, width), jnp.float32))


@struct.dataclass
class ReGIRGrid:
    """Camera-centered world-space cell reservoirs (ReGIR onion analogue)
    with N_FALLBACK_CELLS power-RIS rows appended (outside-grid candidate
    source). `packed` = (C+F, S) f32, each an f16 pair
    [compact_light_id | weight], for one-gather candidate fetches."""
    light_index: jnp.ndarray  # (C+F, S) int32 compact light ids
    weight: jnp.ndarray       # (C+F, S) RIS weight W per slot
    packed: jnp.ndarray       # (C+F, S) f32 (f16 pairs)
    origin: jnp.ndarray       # (3,) grid corner
    cell_size: jnp.ndarray    # scalar


# ----------------------------------------------------------------------------
# surface bundle (RAB_Surface analogue)


@struct.dataclass
class Surface:
    """What the RAB_* callbacks reconstruct from the G-buffer
    (RTXDIAppBridge.hlsli:293-348)."""
    valid: jnp.ndarray
    position: jnp.ndarray
    view: jnp.ndarray          # unit vector toward the camera
    bsdf: bxdf.BSDF
    sv: bxdf.SurfaceVectors
    lobe_weights: jnp.ndarray
    depth: jnp.ndarray
    normal: jnp.ndarray


def make_surface(gbuf) -> Surface:
    mat = gbuf.mat
    surf = gbuf.surf
    sv = bxdf.make_surface_vectors(surf.is_front_face, surf.geometric_normal,
                                   mat.shading_normal)
    bs = bxdf.make_bsdf(mat.base_color, mat.metallic, mat.roughness, mat.ior,
                        mat.transmission, surf.is_front_face)
    v = -gbuf.ray_direction
    return Surface(valid=surf.valid, position=surf.position, view=v,
                   bsdf=bs, sv=sv, lobe_weights=bxdf.lobe_weights(bs, sv, v),
                   depth=gbuf.linear_depth, normal=mat.shading_normal)


def _uv_from_direction(rows: light_mod.LightRows, surface_pos, direction):
    """Invert the sampling map: world direction toward a light (its
    pre-gathered row) -> the (u, v) uniforms that would generate it (for
    folding BRDF-ray candidates into the (light, uv) reservoir domain).
    Sphere rows invert cone sampling; triangle rows invert the
    Math::SampleTriangle area warp (light.triangle_uv_from_direction)."""
    uv_s, in_s = _uv_from_direction_sphere(rows, surface_pos, direction)
    if rows.kind is None:
        return uv_s, in_s
    uv_t, in_t = light_mod.triangle_uv_from_direction(rows, surface_pos,
                                                      direction)
    tri = rows.kind
    return (jnp.where(tri[..., None], uv_t, uv_s),
            jnp.where(tri, in_t, in_s))


def _uv_from_direction_sphere(rows, surface_pos, direction):
    center = rows.center
    radius = rows.radius
    to_c = center - surface_pos
    dist_c = jnp.maximum(m.length(to_c), 1e-6)
    w = to_c / dist_c[..., None]
    sin_max_sq = jnp.clip((radius / dist_c) ** 2, 0.0, 1.0 - 1e-6)
    cos_max = jnp.sqrt(1.0 - sin_max_sq)
    cos_t = jnp.clip(m.dot(direction, w), -1.0, 1.0)
    u0 = jnp.clip((1.0 - cos_t) / jnp.maximum(1.0 - cos_max, 1e-8),
                  0.0, 1.0)
    t, b = m.orthonormal_basis(w)
    phi = jnp.arctan2(m.dot(direction, b), m.dot(direction, t))
    u1 = jnp.mod(phi / (2.0 * jnp.pi), 1.0)
    inside_cone = cos_t >= cos_max
    return jnp.stack([u0, u1], axis=-1), inside_cone


def _target_pdf_rows(surface: Surface, rows: light_mod.LightRows, uv):
    """p_hat from pre-fetched light rows: the unshadowed contribution
    integrand of the sample at this surface, in *uv-square measure*: the
    reservoir domain is (light id, cone-sampling uniforms), so the
    solid-angle integrand picks up the cone Jacobian dω/duv = 1/cone_pdf.
    Omitting it scales DI by ~1/solid-angle per light (vastly over-bright
    for small lights). Also returns the shading pieces (direction,
    distance, f_diffuse, f_specular, emission, inv_cone_pdf)."""
    direction, dist, cone_pdf, emission = light_mod.sample_light_rows(
        rows, surface.position, uv)
    diff, spec = bxdf.eval_split(surface.bsdf, surface.sv, direction,
                                 surface.view, surface.lobe_weights)
    inv_cone = 1.0 / jnp.maximum(cone_pdf, 1e-12)
    contrib = (diff + spec) * emission
    p_hat = m.luminance(contrib) * inv_cone
    is_light = rows.power > 0
    p_hat = jnp.where(surface.valid & is_light, p_hat, 0.0)
    return p_hat, direction, dist, diff, spec, emission, inv_cone


def _target_pdf(surface: Surface, lights: light_mod.Lights, idx, uv):
    """`_target_pdf_rows` plus the compact-row fetch (light.fetch_rows).
    Returns the 7 shading pieces plus the fetched rows (rows.aux = source
    object id, needed for visibility-ray self-exclusion)."""
    rows = light_mod.fetch_rows(lights, idx)
    return _target_pdf_rows(surface, rows, uv) + (rows,)


def _target_pdf_with_bsdf(surface: Surface, lights: light_mod.Lights, idx,
                          uv):
    """_target_pdf plus the BSDF mixture pdf of the generated direction in
    uv measure (shares the row fetch and cone sampling — the MIS 'other
    technique' density for light candidates)."""
    p_hat, direction, dist, diff, spec, emission, inv_cone, _rows = \
        _target_pdf(surface, lights, idx, uv)
    p_w = bxdf.eval_pdf(surface.bsdf, surface.sv, direction, surface.view,
                        surface.lobe_weights)
    return p_hat, p_w * inv_cone


# ----------------------------------------------------------------------------
# ReGIR grid build (ReGIRPresampling.hlsl analogue)


# Fallback rows appended after the ReGIR cells: pure power-RIS draws (the
# RTXDI presampled-tile path) serving pixels outside the grid volume. They
# live in the same packed table so initial sampling needs a single
# candidate-row fetch regardless of grid coverage.
N_FALLBACK_CELLS = 64


def build_regir_grid(lights: light_mod.Lights, camera_position,
                     cfg: ReSTIRConfig, frame_index) -> ReGIRGrid:
    n = cfg.regir_cells_per_axis
    c_total = n * n * n
    s = cfg.regir_slots_per_cell
    extent = n * cfg.regir_cell_size
    origin = camera_position - extent / 2.0

    # Cell centers.
    ids = jnp.arange(c_total, dtype=jnp.int32)
    iz = ids % n
    iy = (ids // n) % n
    ix = ids // (n * n)
    centers = origin + (jnp.stack([ix, iy, iz], axis=-1).astype(jnp.float32)
                        + 0.5) * cfg.regir_cell_size

    rng = rng_mod.init(ids[:, None] * s + jnp.arange(s)[None, :],
                       jnp.full((c_total, s), 7777, jnp.int32), frame_index)

    best_idx = jnp.zeros((c_total, s), jnp.int32)
    w_sum = jnp.zeros((c_total, s), jnp.float32)
    best_phat = jnp.zeros((c_total, s), jnp.float32)
    for _ in range(cfg.regir_build_samples):
        u_pick, rng = rng_mod.next_float(rng)
        u_keep, rng = rng_mod.next_float(rng)
        idx, pick_pdf = light_mod.sample_light_index(lights, u_pick)
        rows = light_mod.fetch_rows(lights, idx)
        # Cell target: power / squared distance (ReGIR cell importance).
        d2 = jnp.sum((rows.center - centers[:, None, :]) ** 2, axis=-1)
        p_hat = rows.power / jnp.maximum(d2, cfg.regir_cell_size ** 2)
        w = jnp.where(pick_pdf > 0, p_hat / jnp.maximum(pick_pdf, 1e-20), 0.0)
        w_sum = w_sum + w
        take = (u_keep * w_sum) < w
        best_idx = jnp.where(take, idx, best_idx)
        best_phat = jnp.where(take, p_hat, best_phat)

    w_out = jnp.where(best_phat > 0,
                      w_sum / (cfg.regir_build_samples
                               * jnp.maximum(best_phat, 1e-20)), 0.0)

    # Fallback rows: single-sample power RIS per slot, so the candidate
    # weight W = 1/pdf — the power-sampling density in RIS-weight form.
    fb = N_FALLBACK_CELLS
    fb_rng = rng_mod.init(
        jnp.arange(fb, dtype=jnp.int32)[:, None] * s
        + jnp.arange(s, dtype=jnp.int32)[None, :],
        jnp.full((fb, s), 3131, jnp.int32), frame_index)
    u_fb, _ = rng_mod.next_float(fb_rng)
    fb_idx, fb_pdf = light_mod.sample_light_index(lights, u_fb)
    fb_w = jnp.where(fb_pdf > 0, 1.0 / jnp.maximum(fb_pdf, 1e-20), 0.0)

    all_idx = jnp.concatenate([best_idx, fb_idx])
    all_w = jnp.concatenate([w_out, fb_w])
    # One f32 per slot (f16 pair [compact_id | W]): the per-pixel slot
    # prefetch in initial sampling is random-access-bandwidth-bound, so
    # the row shrinks from s*8 to s*4 bytes. Compact ids (< 2048) are
    # f16-exact; W carries ~1e-3 relative error, which cancels between
    # the RIS weight and the MIS density built from it.
    packed = m.pack2f16(all_idx.astype(jnp.float32), all_w)
    return ReGIRGrid(light_index=all_idx, weight=all_w, packed=packed,
                     origin=origin, cell_size=jnp.float32(cfg.regir_cell_size))


def _cell_of(grid: ReGIRGrid, position, n: int):
    rel = (position - grid.origin) / grid.cell_size
    ijk = jnp.floor(rel).astype(jnp.int32)
    inside = jnp.all((ijk >= 0) & (ijk < n), axis=-1)
    ijk = jnp.clip(ijk, 0, n - 1)
    cell = (ijk[..., 0] * n + ijk[..., 1]) * n + ijk[..., 2]
    return cell, inside


# ----------------------------------------------------------------------------
# initial sampling (DIInitialSampling.hlsl)


def initial_sampling(surface: Surface, scene: SphereScene,
                     lights: light_mod.Lights, grid: ReGIRGrid | None,
                     cfg: ReSTIRConfig, frame_index,
                     block_size: int = 16384) -> Reservoirs:
    h, w = surface.depth.shape
    px = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    py = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    rng = rng_mod.init(px + 17, py + 31, frame_index * 3 + 1)

    s = cfg.regir_slots_per_cell
    if cfg.local_light_mode == "ReGIR_RIS":
        cell, inside = _cell_of(grid, surface.position,
                                cfg.regir_cells_per_axis)
        c_total = cfg.regir_cells_per_axis ** 3

        # Pixels outside the grid volume draw from one of the power-RIS
        # fallback rows appended to the grid (RTXDI presampled-tile
        # fallback); the cell pick is per-pixel per-frame, candidate
        # variety within the frame comes from the slot pick (the RTXDI
        # screen-tile presampling pattern).
        u_fb, rng = rng_mod.next_float(rng)
        fb_cell = c_total + jnp.minimum(
            (u_fb * N_FALLBACK_CELLS).astype(jnp.int32),
            N_FALLBACK_CELLS - 1)
        cell_eff = jnp.where(inside, cell, fb_cell)

        # ONE candidate-row prefetch for ALL rounds: every slot of the
        # pixel's cell in a single wide gather ((H, W) x s packed f32),
        # instead of a grid-row + tile-row gather per round.
        rows_all = grid.packed[cell_eff]

    res_idx = jnp.zeros((h, w), jnp.int32)
    res_uv = jnp.zeros((h, w, 2), jnp.float32)
    res_phat = jnp.zeros((h, w), jnp.float32)
    w_sum = jnp.zeros((h, w), jnp.float32)
    m_count = jnp.zeros((h, w), jnp.float32)

    n_l = cfg.local_light_samples
    n_b = cfg.brdf_samples
    m_total = float(n_l + n_b)

    n_valid = jnp.sum((lights.compact[:, 7] > 0).astype(jnp.float32))

    def pick_candidate(u_slot):
        """Candidate light id + RIS source weight from one uniform (works
        on (H, W) draws or a stacked (n_l, H, W) batch — everything
        broadcasts)."""
        if cfg.local_light_mode == "Power_RIS":
            # Fresh power-proportional draw per candidate (the reference's
            # presampled-tile Power RIS collapsed to CDF inversion).
            cand, pick_pdf = light_mod.sample_light_index(lights, u_slot)
            w_cand = jnp.where(pick_pdf > 0,
                               1.0 / jnp.maximum(pick_pdf, 1e-20), 0.0)
        elif cfg.local_light_mode == "Uniform":
            # Uniform over the valid compact lights (they sort first).
            cand = jnp.minimum((u_slot * n_valid).astype(jnp.int32),
                               jnp.maximum(n_valid - 1, 0).astype(jnp.int32))
            w_cand = jnp.broadcast_to(n_valid, cand.shape)
        else:
            # Slot select from the prefetched ReGIR rows (s-way select
            # chain — cheap VPU work instead of a gather; selects, not
            # masked adds, because arithmetic on packed bit patterns can
            # canonicalize NaN payloads).
            slot = jnp.minimum((u_slot * s).astype(jnp.int32), s - 1)
            row = jnp.broadcast_to(rows_all[..., 0], u_slot.shape)
            for i in range(1, s):
                row = jnp.where(slot == i, rows_all[..., i], row)
            cand_f, w_cand = m.unpack2f16(row)
            cand = jnp.round(cand_f).astype(jnp.int32)
        return cand, w_cand

    def candidate_weight(surf, cand, uv, w_cand):
        """Balance-heuristic MIS against the BRDF-sampling technique
        (DIInitialSampling's light/BRDF candidate mix): each candidate's
        RIS weight is p_hat over the count-weighted mixture density
        (x M to match the W = w_sum/(M p_hat) storage convention)."""
        if n_b > 0:
            p_self = 1.0 / jnp.maximum(w_cand, 1e-20)
            p_hat, p_other = _target_pdf_with_bsdf(surf, lights, cand, uv)
            wi = m_total * p_hat / jnp.maximum(
                n_l * p_self + n_b * p_other, 1e-20)
            wi = jnp.where(w_cand > 0, wi, 0.0)
        else:
            p_hat = _target_pdf(surf, lights, cand, uv)[0]
            wi = p_hat * w_cand
        return p_hat, wi

    if cfg.candidate_batch and n_l > 0:
        # One batched (n_l, H, W) evaluation: identical draws, update
        # order, and arithmetic as the sequential loop (bit-equal output)
        # — but surface fields stream once for all candidates and the n_l
        # one-hot row fetches fuse into a single taller matmul.
        u_slots, u_keeps, uvs = [], [], []
        for _ in range(n_l):
            u2, rng = rng_mod.next_floats(rng, 2)
            uv, rng = rng_mod.next_floats(rng, 2)
            u_slots.append(u2[..., 0])
            u_keeps.append(u2[..., 1])
            uvs.append(uv)
        cand_all, w_cand_all = pick_candidate(jnp.stack(u_slots))
        surf_b = jax.tree.map(lambda x: x[None], surface)
        p_hat_all, wi_all = candidate_weight(surf_b, cand_all,
                                             jnp.stack(uvs), w_cand_all)
        for i in range(n_l):
            wi = wi_all[i]
            w_sum = w_sum + wi
            m_count = m_count + 1.0
            take = (u_keeps[i] * w_sum) < wi
            res_idx = jnp.where(take, cand_all[i], res_idx)
            res_uv = jnp.where(take[..., None], uvs[i], res_uv)
            res_phat = jnp.where(take, p_hat_all[i], res_phat)
    else:
        for _ in range(n_l):
            u2, rng = rng_mod.next_floats(rng, 2)
            uv, rng = rng_mod.next_floats(rng, 2)
            u_slot, u_keep = u2[..., 0], u2[..., 1]
            cand, w_cand = pick_candidate(u_slot)
            p_hat, wi = candidate_weight(surface, cand, uv, w_cand)
            w_sum = w_sum + wi
            m_count = m_count + 1.0
            take = (u_keep * w_sum) < wi
            res_idx = jnp.where(take, cand, res_idx)
            res_uv = jnp.where(take[..., None], uv, res_uv)
            res_phat = jnp.where(take, p_hat, res_phat)

    # BRDF-ray candidates (DIInitialSampling.hlsl BRDF samples): sample the
    # BSDF, find the nearest LIGHT along the ray (a 128-light sweep — 3.5x
    # cheaper than the full-scene closest hit), verify nothing occludes it
    # with the any-hit kernel, and fold the hit into the reservoir domain.
    for _ in range(n_b):
        rand4, rng = rng_mod.next_floats(rng, 4)
        u_keep2, rng = rng_mod.next_float(rng)
        l_dir, lobe, valid_dir = bxdf.sample(surface.bsdf, surface.sv,
                                             surface.view, rand4)
        origin = intersect.safe_spawn_point(
            surface.position, surface.sv.front_geometric_normal, l_dir)
        ray_live = surface.valid & valid_dir
        lhit = intersect.intersect_spheres(
            origin, l_dir, jnp.zeros((h, w)),
            jnp.where(ray_live, jnp.inf, -1.0),
            lights.compact[:, 0:3], lights.compact[:, 3], block_size,
            attributes=False)
        light_t = jnp.where(lhit.hit, lhit.t, jnp.inf)
        cand_b = lhit.index                           # compact light id
        hit_light = lhit.hit
        if lights.has_triangles:
            # Triangle-light candidates: Möller-Trumbore against the
            # compact rows' world edges (sphere rows have degenerate edges
            # and never hit). Bary (u, v) invert the area warp directly.
            tri_t, tri_id, tri_u, tri_v = _intersect_tri_lights(
                lights, origin, l_dir, ray_live)
            closer = tri_t < light_t
            cand_b = jnp.where(closer, tri_id, cand_b)
            light_t = jnp.minimum(light_t, tri_t)
            hit_light = hit_light | jnp.isfinite(tri_t)
            tri_s = jnp.clip(tri_u + tri_v, 0.0, 1.0)
            uv_tri_hit = jnp.stack(
                [tri_s * tri_s,
                 jnp.clip(tri_v / jnp.maximum(tri_s, 1e-9), 0.0, 1.0)],
                axis=-1)
        krows = light_mod.fetch_rows(lights, cand_b)
        # Occluder test: anything (sphere or mesh, alpha-aware) closer
        # than the light surface, excluding the light itself. Lanes whose
        # BRDF ray found no light are dead here — their occlusion bit is
        # never read (is_emissive is already false).
        occ_b = _occluded(origin, l_dir, light_t, scene, krows.aux,
                          block_size, live=ray_live & hit_light)
        is_emissive = hit_light & (krows.power > 0) & ~occ_b
        uv_b, inside_cone = _uv_from_direction(krows, surface.position,
                                               l_dir)
        if lights.has_triangles:
            # For triangle hits the exact bary-derived uv beats the plane
            # reconstruction (same value, fewer ops / no edge cases).
            took_tri = krows.kind & jnp.isfinite(tri_t)
            uv_b = jnp.where(took_tri[..., None], uv_tri_hit, uv_b)
            inside_cone = inside_cone | took_tri
        ok = is_emissive & inside_cone & ray_live

        p_w = bxdf.eval_pdf(surface.bsdf, surface.sv, l_dir, surface.view,
                            surface.lobe_weights)
        _, _, cone_pdf_b, _ = light_mod.sample_light_rows(
            krows, surface.position, uv_b)
        p_self = p_w / jnp.maximum(cone_pdf_b, 1e-12)
        if cfg.local_light_mode == "Uniform":
            p_light = jnp.where(krows.power > 0,
                                1.0 / jnp.maximum(n_valid, 1.0), 0.0)
        else:
            # MIS "light technique" density approximated by the power pdf
            # even where candidates actually came from the ReGIR grid
            # (whose position-dependent marginal is unavailable per-lane)
            # — the same approximation RTXDI's BRDF-candidate MIS makes;
            # the residual DI bias is bounded by the pairwise unbiasedness
            # test (<=2%).
            p_light = krows.power / jnp.maximum(lights.total_power, 1e-20)
        p_hat_b = _target_pdf_rows(surface, krows, uv_b)[0]
        p_hat_b = jnp.where(ok, p_hat_b, 0.0)
        wi = jnp.where(ok & (p_self > 0),
                       m_total * p_hat_b / jnp.maximum(
                           n_b * p_self + n_l * p_light, 1e-20), 0.0)
        w_sum = w_sum + wi
        m_count = m_count + 1.0
        take = (u_keep2 * w_sum) < wi
        res_idx = jnp.where(take, jnp.maximum(cand_b, 0), res_idx)
        res_uv = jnp.where(take[..., None], uv_b, res_uv)
        res_phat = jnp.where(take, p_hat_b, res_phat)
    w_out = jnp.where(res_phat > 0,
                      w_sum / (jnp.maximum(m_count, 1.0)
                               * jnp.maximum(res_phat, 1e-20)), 0.0)

    # Initial visibility ray (DIInitialSampling final visibility test).
    # Dead where the reservoir is already worthless (sky pixels, empty
    # streams): the any-hit pass only pays for lanes whose bit is read.
    _, direction, dist, _, _, _, _, rows = _target_pdf(surface, lights,
                                                       res_idx, res_uv)
    excl = rows.aux
    origin = intersect.safe_spawn_point(surface.position,
                                        surface.sv.front_geometric_normal,
                                        direction)
    occluded = _occluded(origin, direction, dist, scene, excl,
                         block_size,
                         live=surface.valid & (w_out > 0))
    w_out = jnp.where(occluded | ~surface.valid, 0.0, w_out)

    return Reservoirs(light_index=res_idx, uv=res_uv, w_sum=w_sum,
                      m_count=m_count, w_out=w_out, phat=res_phat)


def _intersect_tri_lights(lights: light_mod.Lights, origin, direction,
                          live):
    """Closest hit against the COMPACT table's triangle-light rows (the
    BRDF-candidate analogue of the sphere-light sweep): Möller-Trumbore
    over <= MAX_LIGHTS world-space triangles. Sphere rows carry degenerate
    (zero) edges and can never hit. Returns (t (inf = miss), compact id,
    bary_u, bary_v)."""
    import types

    from . import trimesh
    comp = lights.compact
    e1 = comp[:, 9:12]
    e2 = comp[:, 12:15]
    v0 = comp[:, 0:3] - (e1 + e2) / 3.0
    mesh = types.SimpleNamespace(v0=v0, e1=e1, e2=e2)
    t, face, u, v = trimesh.intersect_mesh(
        origin, direction, jnp.zeros(live.shape),
        jnp.where(live, jnp.inf, -1.0), mesh)
    return (jnp.where(jnp.isfinite(t), t, jnp.inf),
            face.astype(jnp.int32), u, v)


def _occluded(origin, direction, light_dist, scene, exclude_obj,
              block_size: int, live=None):
    """Visibility ray toward the selected light (RAB_GetConservativeVisibility,
    RTXDIAppBridge.hlsli:418-459): blocked if anything (sphere or mesh) is
    hit closer than the light surface. `exclude_obj` is the light's OBJECT
    id (rows.aux from a compact fetch), excluded from the occluder set.

    `live` masks lanes whose result the caller will discard (no light hit,
    zero reservoir weight, invalid surface): they get a dead t-range, so
    they hit nothing and a mesh sweep's bounding-sphere cull skips them."""
    from . import trace as trace_mod
    max_dist = jnp.maximum(light_dist - 1e-3, 0.0)
    if live is not None:
        max_dist = jnp.where(live, max_dist, -1.0)
    return trace_mod.occluded_scene(
        scene, origin, direction, max_dist,
        exclude_obj, block_size)


# ----------------------------------------------------------------------------
# reservoir merge helper


def _merge(a_idx, a_uv, a_phat, a_wsum, a_m, b_idx, b_uv, b_w, b_m, b_phat,
           u_keep):
    """Merge reservoir stream B (summarized as one sample with weight
    b_w = p_hat_b * W_b * M_b) into A. Returns updated A fields."""
    w_sum = a_wsum + b_w
    m_count = a_m + b_m
    take = (u_keep * w_sum) < b_w
    return (jnp.where(take, b_idx, a_idx),
            jnp.where(take[..., None], b_uv, a_uv),
            jnp.where(take, b_phat, a_phat),
            w_sum, m_count)


def _finalize(idx, uv, phat, w_sum, m_count):
    w_out = jnp.where(phat > 0,
                      w_sum / (jnp.maximum(m_count, 1.0)
                               * jnp.maximum(phat, 1e-20)), 0.0)
    return Reservoirs(light_index=idx, uv=uv, w_sum=w_sum, m_count=m_count,
                      w_out=w_out, phat=phat)


# ----------------------------------------------------------------------------
# temporal resampling (DITemporalResampling.hlsl)


def _pack_reservoirs(res: Reservoirs, depth, normal, extra=None):
    """(H, W, 4[+E]) packed reservoir + guide rows for one-gather neighbor
    fetches, bit-packed where precision allows (the fetch is
    bandwidth-bound):
    [idx|m, uv, w_out, depth|oct8 normal]. idx <= 2048 and M counts are
    exact/near-exact in f16; uv quantization (~1e-3) perturbs the
    re-evaluated target pdf identically in numerator and stream weight,
    preserving unbiasedness (validated by the 2% test); the 8-bit normal
    only guides the >= 0.5-dot similarity test."""
    cols = [
        m.pack2f16(res.light_index.astype(jnp.float32), res.m_count),
        m.pack2f16(res.uv[..., 0], res.uv[..., 1]),
        res.w_out,
        m.pack_depth_oct8(depth, normal),
    ]
    packed = jnp.stack(cols, axis=-1)
    if extra is not None:
        packed = jnp.concatenate([packed, extra], axis=-1)
    return packed


def _unpack_fetched(row):
    """Packed reservoir rows -> (idx, uv, m_count, w_out, depth, normal,
    extra)."""
    idx_f, m_count = m.unpack2f16(row[..., 0])
    u0, u1 = m.unpack2f16(row[..., 1])
    depth, normal = m.unpack_depth_oct8(row[..., 3])
    return (jnp.round(idx_f).astype(jnp.int32),
            jnp.stack([u0, u1], axis=-1), m_count, row[..., 2],
            depth, normal, row[..., 4:])


def _fetch_packed(packed, iy, ix):
    """-> (idx, uv, m_count, w_out, depth, normal, extra)."""
    h, w = packed.shape[:2]
    flat = packed.reshape(-1, packed.shape[-1])
    return _unpack_fetched(flat[iy * w + ix])


def pack_prev_material(gbuf):
    """(H, W, 7) rows carrying what RAB_GetGBufferSurface(previousFrame)
    reads from the previous G-buffer (RTXDIAppBridge.hlsli:293-348):
    world position (f32 x3) + f16 pairs [r|g, b|metallic, roughness|ior,
    transmission|valid]. The pipeline stores this from each frame's
    G-buffer; temporal_resampling reprojects it alongside the reservoir
    rows (one shared windowed fetch) to rebuild the REAL previous surface
    for pairwise temporal bias correction (temporal_prev_surface="real")."""
    mat = gbuf.mat
    surf = gbuf.surf
    return jnp.concatenate([
        surf.position,
        m.pack2f16(mat.base_color[..., 0], mat.base_color[..., 1])[..., None],
        m.pack2f16(mat.base_color[..., 2], mat.metallic)[..., None],
        m.pack2f16(mat.roughness, mat.ior)[..., None],
        m.pack2f16(mat.transmission,
                   surf.valid.astype(jnp.float32))[..., None],
    ], axis=-1)


def _prev_surface_from_rows(mrows, pn, pd, hist_ok, prev_camera_position,
                            fallback_view):
    """Rebuild the previous-frame Surface from reprojected
    pack_prev_material rows (the previousFrame branch of
    RAB_GetGBufferSurface, incl. its MinRoughness=0.05 validity gate)."""
    pos_p = mrows[..., 0:3]
    cr, cg = m.unpack2f16(mrows[..., 3])
    cb, metal = m.unpack2f16(mrows[..., 4])
    rough, ior = m.unpack2f16(mrows[..., 5])
    trans, pvalid_f = m.unpack2f16(mrows[..., 6])
    valid_p = hist_ok & (pvalid_f > 0.5) & (rough >= 0.05)
    if prev_camera_position is not None:
        view_p = m.normalize(prev_camera_position - pos_p)
    else:
        view_p = fallback_view
    front_p = m.dot(pn, view_p) > 0
    sv_p = bxdf.make_surface_vectors(front_p, pn, pn)
    bs_p = bxdf.make_bsdf(jnp.stack([cr, cg, cb], axis=-1), metal, rough,
                          ior, trans, front_p)
    return Surface(valid=valid_p, position=pos_p, view=view_p, bsdf=bs_p,
                   sv=sv_p,
                   lobe_weights=bxdf.lobe_weights(bs_p, sv_p, view_p),
                   depth=pd, normal=pn)


def temporal_resampling(cur: Reservoirs, prev: Reservoirs, surface: Surface,
                        lights: light_mod.Lights, motion, prev_depth,
                        prev_normal, cfg: ReSTIRConfig,
                        frame_index, scene=None,
                        block_size: int = 16384, prev_material=None,
                        prev_camera_position=None) -> Reservoirs:
    h, w = surface.depth.shape
    pairwise = cfg.temporal_bias_correction in ("pairwise", "raytraced")
    real_prev = (pairwise and cfg.temporal_prev_surface == "real"
                 and prev_material is not None)
    extra = prev.phat[..., None] if pairwise else None
    if real_prev:
        extra = jnp.concatenate([extra, prev_material], axis=-1)
    packed = _pack_reservoirs(prev, prev_depth, prev_normal, extra)
    row, in_bounds = reproject(packed, motion, "nearest")
    p_idx, p_uv, p_m, p_w, pd, pn, rest = _unpack_fetched(row)

    # History validity (depth/normal similarity like the denoiser's test).
    depth_ok = jnp.abs(pd - surface.depth) \
        <= cfg.depth_threshold * jnp.maximum(jnp.abs(surface.depth), 1e-3)
    normal_ok = m.dot(pn, surface.normal) >= cfg.normal_threshold
    hist_ok = in_bounds & depth_ok & normal_ok & surface.valid

    # Clamp history length (RTXDI maxHistoryLength * current M).
    p_m = jnp.minimum(p_m, cfg.max_history * jnp.maximum(cur.m_count, 1.0))
    p_m = jnp.where(hist_ok, p_m, 0.0)

    # Re-evaluate the history sample's target pdf at the current surface.
    p_phat = _target_pdf(surface, lights, p_idx, p_uv)[0]
    b_w = p_phat * p_w * p_m

    rng = rng_mod.init(jnp.arange(w)[None, :] + 3,
                       jnp.arange(h)[:, None] + 5, frame_index * 3 + 2)
    u_keep, rng = rng_mod.next_float(rng)

    cur_phat = cur.phat  # evaluated at this surface by initial sampling
    if pairwise:
        # Pairwise-MIS temporal reuse (MyAppData.h:226-239, temporal
        # BiasCorrectionMode Pairwise/Raytraced): the single history
        # "neighbor" is MIS-balanced against the canonical reservoir with
        # confidence weights — the k=1 case of _spatial_pairwise's
        # weights. p̂_i(x_i) rides the packed history row (stored exact);
        # the previous-surface evaluation of the CURRENT sample uses the
        # pseudo-previous surface described on temporal_bias_correction.
        raytraced = (cfg.temporal_bias_correction == "raytraced"
                     and scene is not None)
        p_phat_prev = jnp.where(hist_ok, rest[..., 0], 0.0)
        if real_prev:
            psurf = _prev_surface_from_rows(rest[..., 1:8], pn, pd, hist_ok,
                                            prev_camera_position,
                                            surface.view)
        else:
            # Pseudo-previous surface: current BSDF + reprojected normal
            # (see ReSTIRConfig.temporal_prev_surface).
            sv_p = bxdf.make_surface_vectors(jnp.ones_like(hist_ok), pn, pn)
            psurf = Surface(valid=hist_ok, position=surface.position,
                            view=surface.view, bsdf=surface.bsdf, sv=sv_p,
                            lobe_weights=bxdf.lobe_weights(surface.bsdf,
                                                           sv_p,
                                                           surface.view),
                            depth=pd, normal=pn)
        phat_c_xi = p_phat                     # current surface, history x
        phat_i_xc = _target_pdf(psurf, lights, cur.light_index, cur.uv)[0]
        if raytraced:
            _, direction, dist, _, _, _, _, rows_v = _target_pdf(
                surface, lights, p_idx, p_uv)
            origin = intersect.safe_spawn_point(
                surface.position, surface.sv.front_geometric_normal,
                direction)
            occ = _occluded(origin, direction, dist, scene, rows_v.aux,
                            block_size,
                            live=hist_ok & (phat_c_xi > 0))
            phat_c_xi = jnp.where(occ, 0.0, phat_c_xi)
        m_c = cur.m_count
        a_xc = p_m * phat_i_xc
        f_xc = m_c * cur_phat
        mc_weight = jnp.where(f_xc > 0,
                              f_xc / jnp.maximum(a_xc + f_xc, 1e-20), 0.0)
        a_xi = p_m * p_phat_prev
        m_i = jnp.where(p_m > 0, a_xi / jnp.maximum(
            a_xi + m_c * phat_c_xi, 1e-20), 0.0)
        b_w2 = m_i * phat_c_xi * p_w
        w_sum = mc_weight * cur_phat * cur.w_out + b_w2
        take = (u_keep * w_sum) < b_w2
        idx = jnp.where(take, p_idx, cur.light_index)
        uv = jnp.where(take[..., None], p_uv, cur.uv)
        phat = jnp.where(take, phat_c_xi, cur_phat)
        m_count = cur.m_count + p_m
        w_out = jnp.where(phat > 0, w_sum / jnp.maximum(phat, 1e-20), 0.0)
        out = Reservoirs(light_index=idx, uv=uv, w_sum=w_sum,
                         m_count=m_count, w_out=w_out, phat=phat)
    else:
        idx, uv, phat, w_sum, m_count = _merge(
            cur.light_index, cur.uv, cur_phat,
            cur_phat * cur.w_out * cur.m_count, cur.m_count,
            p_idx, p_uv, b_w, p_m, p_phat, u_keep)
        out = _finalize(idx, uv, phat, w_sum, m_count)

    # Boiling filter (DITemporalResampling.hlsl boiling filter): kill
    # reservoirs whose weight far exceeds the local neighborhood average.
    if cfg.boiling_filter_strength > 0:
        weight = out.w_out * phat
        local = _avg_pool(weight, 16)
        threshold = local * (1.0 + 9.0 * (1.0 - cfg.boiling_filter_strength))
        boiling = weight > jnp.maximum(threshold, 1e-12)
        out = out.replace(w_out=jnp.where(boiling, 0.0, out.w_out))
    return out


def _avg_pool(x, size: int):
    h, w = x.shape
    ph = (-h) % size
    pw = (-w) % size
    xp = jnp.pad(x, ((0, ph), (0, pw)))
    hh, ww = xp.shape
    pooled = xp.reshape(hh // size, size, ww // size, size).mean(axis=(1, 3))
    up = jnp.repeat(jnp.repeat(pooled, size, axis=0), size, axis=1)
    return up[:h, :w]


# ----------------------------------------------------------------------------
# spatial resampling (DISpatialResampling.hlsl)


def _pack_surface_rows(surface: Surface):
    """(H, W, 30) rows carrying everything needed to re-evaluate a target
    pdf AT a gathered neighbor surface (the RAB_GetGBufferSurface fetch,
    RTXDIAppBridge.hlsli:293-348, packed for ONE wide row gather)."""
    bs = surface.bsdf
    return jnp.concatenate([
        surface.position, surface.normal, surface.view,
        surface.sv.front_geometric_normal,
        bs.albedo, bs.f0,
        bs.roughness[..., None], bs.ior_i[..., None], bs.ior_o[..., None],
        bs.transmission[..., None], bs.metallic[..., None],
        bs.base_color, surface.lobe_weights,
        surface.valid.astype(jnp.float32)[..., None],
    ], axis=-1)


def _surface_from_rows(rows):
    """Rebuild a Surface view from _pack_surface_rows output (tangent basis
    re-derived deterministically from the shading normal)."""
    nrm = rows[..., 3:6]
    t, b = m.orthonormal_basis(nrm)
    sv = bxdf.SurfaceVectors(front_geometric_normal=rows[..., 9:12],
                             shading_normal=nrm, tangent=t, bitangent=b)
    bs = bxdf.BSDF(base_color=rows[..., 23:26], metallic=rows[..., 22],
                   albedo=rows[..., 12:15], roughness=rows[..., 18],
                   ior_i=rows[..., 19], ior_o=rows[..., 20],
                   f0=rows[..., 15:18], transmission=rows[..., 21])
    return Surface(valid=rows[..., 29] > 0.5, position=rows[..., 0:3],
                   view=rows[..., 6:9], bsdf=bs, sv=sv,
                   lobe_weights=rows[..., 26:29],
                   depth=jnp.zeros_like(rows[..., 18]), normal=nrm)


def _spatial_neighbors(cur, surface, cfg, frame_index, with_surface: bool):
    """Draw cfg.spatial_samples disc neighbors; gather their reservoir (and
    optionally full surface) rows; apply the similarity tests. Yields a list
    of dicts."""
    h, w = surface.depth.shape
    rng = rng_mod.init(jnp.arange(w)[None, :] + jnp.zeros((h, 1), jnp.int32),
                       jnp.arange(h)[:, None] + jnp.zeros((1, w), jnp.int32),
                       frame_index * 3 + 3)
    py = jnp.arange(h)[:, None] + jnp.zeros((1, w), jnp.int32)
    px = jnp.arange(w)[None, :] + jnp.zeros((h, 1), jnp.int32)
    sdepth = jnp.where(jnp.isfinite(surface.depth), surface.depth, 1e8)
    extra = _pack_surface_rows(surface) if with_surface else None
    packed = _pack_reservoirs(cur, sdepth, surface.normal, extra)

    out = []
    for s_i in range(cfg.spatial_samples):
        u3, rng = rng_mod.next_floats(rng, 3)
        u_r, u_a, u_keep = u3[..., 0], u3[..., 1], u3[..., 2]
        if cfg.spatial_offset_mode == "shared":
            # One golden-angle disc offset per (round, frame) — scalar —
            # so the neighbor fetch is a dynamic roll instead of a
            # gather (see ReSTIRConfig.spatial_offset_mode). Wrapped
            # border lanes land on the far screen edge and are rejected
            # by the similarity tests like any dissimilar neighbor.
            seq = frame_index * cfg.spatial_samples + s_i
            g = 2.39996323  # golden angle
            rad_s = (0.35 + 0.6 * ((seq * 0.6180339887) % 1.0)) \
                * cfg.spatial_radius + 1.0
            ang_s = seq * g
            dx = jnp.round(rad_s * jnp.cos(ang_s)).astype(jnp.int32)
            dy = jnp.round(rad_s * jnp.sin(ang_s)).astype(jnp.int32)
            rolled = jnp.roll(packed, shift=(-dy, -dx), axis=(0, 1))
            n_idx, n_uv, n_m, n_w, nd, nn, rest = _unpack_fetched(rolled)
        else:
            radius = u_r * cfg.spatial_radius + 1.0
            angle = u_a * 2.0 * jnp.pi
            nx = jnp.clip(px + jnp.round(radius * jnp.cos(angle)).astype(
                jnp.int32), 0, w - 1)
            ny = jnp.clip(py + jnp.round(radius * jnp.sin(angle)).astype(
                jnp.int32), 0, h - 1)
            n_idx, n_uv, n_m, n_w, nd, nn, rest = _fetch_packed(packed, ny,
                                                               nx)
        depth_ok = jnp.abs(nd - sdepth) \
            <= cfg.depth_threshold * jnp.maximum(jnp.abs(sdepth), 1e-3)
        normal_ok = m.dot(nn, surface.normal) >= cfg.normal_threshold
        ok = depth_ok & normal_ok & surface.valid
        n = {"idx": n_idx, "uv": n_uv, "m": jnp.where(ok, n_m, 0.0),
             "w": n_w, "u_keep": u_keep}
        if with_surface:
            n["surface"] = _surface_from_rows(rest)
        out.append(n)
    return out


def _spatial_pairwise(cur: Reservoirs, surface: Surface,
                      lights: light_mod.Lights, cfg: ReSTIRConfig,
                      frame_index, scene=None,
                      block_size: int = 16384) -> Reservoirs:
    """Pairwise-MIS spatial reuse: each neighbor is MIS-balanced against
    the canonical reservoir with confidence (M) weights,

        m_i(x) = M_i p̂_i(x) / (k M_i p̂_i(x) + M_c p̂_c(x))
        m_c(x_c) = (1/k) Σ_i M_c p̂_c(x_c) / (k M_i p̂_i(x_c) + M_c p̂_c(x_c))

    (Σ_j m_j(x) ≡ 1, so resampling stays unbiased — the generalized balance
    heuristic of the RTXDI pairwise bias-correction mode, RTXDI.ixx:73-139).
    Because the m's normalize the stream, the finalize divides by p̂ only
    (no 1/M). "raytraced" mode multiplies the cross-surface target pdfs by
    a traced visibility term, correcting shadow-edge bias as well."""
    raytraced = cfg.spatial_bias_correction == "raytraced" \
        and scene is not None
    k = float(cfg.spatial_samples)
    neighbors = _spatial_neighbors(cur, surface, cfg, frame_index,
                                   with_surface=True)

    phat_c = cur.phat  # evaluated at this surface by the prior stage
    m_c = cur.m_count

    def vis(from_surface, idx, uv):
        """Visibility factor at a surface toward sample (idx, uv)."""
        _, direction, dist, _, _, _, _, rows = _target_pdf(from_surface,
                                                           lights, idx, uv)
        origin = intersect.safe_spawn_point(
            from_surface.position, from_surface.sv.front_geometric_normal,
            direction)
        occ = _occluded(origin, direction, dist, scene, rows.aux, block_size,
                        live=from_surface.valid)
        return (~occ).astype(jnp.float32)

    # Pass 1: cross-evaluations + the canonical MIS weight.
    mc_weight = jnp.zeros_like(phat_c)
    evals = []
    for n in neighbors:
        nsurf = n["surface"]
        phat_i_xi = _target_pdf(nsurf, lights, n["idx"], n["uv"])[0]
        phat_c_xi = _target_pdf(surface, lights, n["idx"], n["uv"])[0]
        phat_i_xc = _target_pdf(nsurf, lights, cur.light_index, cur.uv)[0]
        if raytraced:
            phat_c_xi = phat_c_xi * vis(surface, n["idx"], n["uv"])
            phat_i_xc = phat_i_xc * vis(nsurf, cur.light_index, cur.uv)
        a_xc = k * n["m"] * phat_i_xc
        f_xc = m_c * phat_c
        mc_weight = mc_weight + jnp.where(
            f_xc > 0, f_xc / jnp.maximum(a_xc + f_xc, 1e-20), 0.0) / k
        evals.append((phat_i_xi, phat_c_xi))

    # Pass 2: streaming reservoir merge with the MIS-weighted stream.
    idx, uv = cur.light_index, cur.uv
    phat = phat_c
    w_sum = mc_weight * phat_c * cur.w_out
    m_count = m_c
    for n, (phat_i_xi, phat_c_xi) in zip(neighbors, evals):
        a_xi = k * n["m"] * phat_i_xi
        m_i = jnp.where(n["m"] > 0, n["m"] * phat_i_xi
                        / jnp.maximum(a_xi + m_c * phat_c_xi, 1e-20), 0.0)
        b_w = m_i * phat_c_xi * n["w"]
        w_sum_new = w_sum + b_w
        take = (n["u_keep"] * w_sum_new) < b_w
        idx = jnp.where(take, n["idx"], idx)
        uv = jnp.where(take[..., None], n["uv"], uv)
        phat = jnp.where(take, phat_c_xi, phat)
        w_sum = w_sum_new
        m_count = m_count + n["m"]

    w_out = jnp.where(phat > 0,
                      w_sum / jnp.maximum(phat, 1e-20), 0.0)
    return Reservoirs(light_index=idx, uv=uv, w_sum=w_sum, m_count=m_count,
                      w_out=w_out, phat=phat)


def spatial_resampling(cur: Reservoirs, surface: Surface,
                       lights: light_mod.Lights, cfg: ReSTIRConfig,
                       frame_index, scene=None,
                       block_size: int = 16384) -> Reservoirs:
    if cfg.spatial_bias_correction in ("pairwise", "raytraced"):
        return _spatial_pairwise(cur, surface, lights, cfg, frame_index,
                                 scene=scene,
                                 block_size=block_size)
    # "basic" 1/M mode (material/geometry similarity tests per
    # DISpatialResampling.hlsl:6-41; neighbor target pdfs re-evaluated at
    # the canonical surface only).
    phat = cur.phat  # evaluated at this surface by the prior stage
    idx, uv = cur.light_index, cur.uv
    w_sum = phat * cur.w_out * cur.m_count
    m_count = cur.m_count

    for n in _spatial_neighbors(cur, surface, cfg, frame_index,
                                with_surface=False):
        n_phat = _target_pdf(surface, lights, n["idx"], n["uv"])[0]
        b_w = jnp.where(n["m"] > 0, n_phat * n["w"] * n["m"], 0.0)
        idx, uv, phat, w_sum, m_count = _merge(
            idx, uv, phat, w_sum, m_count, n["idx"], n["uv"], b_w, n["m"],
            n_phat, n["u_keep"])

    return _finalize(idx, uv, phat, w_sum, m_count)


# ----------------------------------------------------------------------------
# final shading (DIFinalShading.hlsl)


def final_shading(res: Reservoirs, surface: Surface, scene: SphereScene,
                  lights: light_mod.Lights, block_size: int = 16384):
    """Returns (diffuse, specular) direct-illumination images (H, W, 3) —
    the channels the denoiser and Raytracing pass consume
    (Raytracing.hlsl:150-163 `directDiffuse/directSpecular`)."""
    p_hat, direction, dist, diff, spec, emission, inv_cone, rows = \
        _target_pdf(surface, lights, res.light_index, res.uv)
    origin = intersect.safe_spawn_point(surface.position,
                                        surface.sv.front_geometric_normal,
                                        direction)
    occluded = _occluded(origin, direction, dist, scene, rows.aux,
                         block_size,
                         live=surface.valid & (res.w_out > 0)
                         & (p_hat > 0))
    # uv-measure integrand (f * Le * dω/duv) times the reservoir weight.
    weight = jnp.where(surface.valid & ~occluded & (p_hat > 0),
                       res.w_out * inv_cone, 0.0)[..., None]
    return diff * emission * weight, spec * emission * weight
