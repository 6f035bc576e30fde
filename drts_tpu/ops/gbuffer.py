"""G-buffer generation: primary visibility + motion vectors + material
channels.

Reimplementation of
/root/reference/Shaders/GBufferGeneration.hlsl:117-232 (host:
Source/GBufferGeneration.ixx): one primary-ray pass writing the channel set
the temporal passes need. Channels are a pytree of dense (H, W, ...) arrays
instead of 13 flag-gated UAVs — XLA dead-code-eliminates anything a given
pipeline variant doesn't read, which is the functional analogue of the
reference's Flags bits (GBufferGeneration.ixx:28-44).

Motion vectors reproject the hit through the *previous* object pose and the
*previous* camera (GBufferGeneration.hlsl:62-91), in pixels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..utils import math as m
from ..models import scene as scene_mod
from . import bxdf, camera as camera_mod, shading, sky, trace as trace_mod


@struct.dataclass
class GBuffer:
    """The reference's G-buffer channel set (SURVEY.md §2.2 row 2)."""
    surf: scene_mod.HitSurface        # primary surface attributes
    mat: shading.EvaluatedMaterial    # post-texture material at the hit
    ray_origin: jnp.ndarray           # (H, W, 3)
    ray_direction: jnp.ndarray        # (H, W, 3)
    linear_depth: jnp.ndarray         # (H, W) view-forward depth (inf miss)
    motion: jnp.ndarray               # (H, W, 2) prev - current, pixels
    radiance: jnp.ndarray             # (H, W, 3) primary emission / env miss
    diffuse_albedo: jnp.ndarray       # (H, W, 3) NRD demodulation albedo
    specular_albedo: jnp.ndarray      # (H, W, 3) NRD specular demodulation


def generate(scene: scene_mod.SphereScene, cam: camera_mod.Camera,
             width: int, height: int, block_size: int = 16384,
             thin_lens: bool = False,
             frame_index=0) -> GBuffer:
    """Primary-ray pass. Pure; jit together with the integrator.

    With ``thin_lens`` the primary rays sample the camera aperture
    (Camera.hlsli:43-54 GenerateThinLensRay); defocus noise converges
    through the temporal accumulation like any other per-pixel jitter."""
    ndc = camera_mod.pixel_ndc(width, height, cam.jitter)
    if thin_lens:
        from ..utils import rng as rng_mod
        px = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
        py = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
        rng = rng_mod.init(px + 977, py + 557, frame_index)
        u2, _ = rng_mod.next_floats(rng, 2)
        ray_o, ray_d, t_min, t_max = camera_mod.generate_thin_lens_rays(
            cam, ndc, u2)
    else:
        ray_o, ray_d, t_min, t_max = camera_mod.generate_pinhole_rays(
            cam, ndc)
        ray_o = jnp.broadcast_to(ray_o, ray_d.shape)
    t_min = jnp.broadcast_to(t_min, (height, width))
    t_max = jnp.broadcast_to(t_max, (height, width))

    table = scene_mod.object_table(scene)
    surf = trace_mod.trace_scene(scene, ray_o, ray_d, t_min, t_max,
                                 block_size, table=table,
                                 alpha_rounds=scene.alpha_test_rounds)
    mat = shading.evaluate_material(surf.material, surf.uv,
                                    surf.shading_normal, surf.tangent,
                                    scene.textures)

    # Demodulation guides (GBufferGeneration.hlsl albedo channels).
    sv = bxdf.make_surface_vectors(surf.is_front_face, surf.geometric_normal,
                                   mat.shading_normal)
    bs = bxdf.make_bsdf(mat.base_color, mat.metallic, mat.roughness, mat.ior,
                        mat.transmission, surf.is_front_face)
    diff_albedo, spec_albedo = bxdf.demodulation_factors(bs, sv, -ray_d)

    # Primary radiance: hit emission, or environment on miss
    # (GBufferGeneration.hlsl emission/env channel; consumed at
    # Raytracing.hlsl:119 as `primaryRadiance`).
    env = sky.environment_color(scene.env, ray_d)
    radiance = jnp.where(surf.valid[..., None], mat.emission, env)

    # Linear depth along the normalized camera forward axis.
    fwd = m.normalize(cam.forward)
    depth = jnp.where(surf.valid,
                      m.dot(surf.position - cam.position, fwd), jnp.inf)

    # Motion vectors: world hit -> object space (current pose) -> world via
    # previous pose -> previous camera NDC -> pixel delta. Pose columns come
    # from the packed object-table row (one gather, see models/scene.py).
    row = table[surf.object_index]
    obj_local = m.quat_rotate(m.quat_conj(row[..., 4:8]),
                              surf.position - row[..., 0:3])
    if surf.prev_offset is not None:
        # Per-vertex motion of deforming meshes (interpolated in
        # trace._surface_of): previousPosition = ObjectPosition + motion
        # before the previous-pose transform (GBufferGeneration.hlsl:70-84).
        obj_local = obj_local + surf.prev_offset
    prev_world = row[..., 8:11] + m.quat_rotate(row[..., 11:15], obj_local)
    prev_ndc, _ = camera_mod.project_to_ndc(cam, prev_world, previous=True)
    cur_ndc, _ = camera_mod.project_to_ndc(cam, surf.position,
                                           previous=False)
    prev_px = camera_mod.ndc_to_pixel(prev_ndc, width, height)
    cur_px = camera_mod.ndc_to_pixel(cur_ndc, width, height)
    motion = jnp.where(surf.valid[..., None], prev_px - cur_px, 0.0)

    return GBuffer(surf=surf, mat=mat, ray_origin=ray_o, ray_direction=ray_d,
                   linear_depth=depth, motion=motion, radiance=radiance,
                   diffuse_albedo=diff_albedo, specular_albedo=spec_albedo)
