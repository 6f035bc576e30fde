"""Scene-level closest-hit: spheres + instanced triangle meshes + alpha test.

The TraceRay/anyhit composite of the reference
(/root/reference/Shaders/RaytracingHelpers.hlsli:7-55 TraceRay with the
alpha-test anyhit loop at :35-40 and the triangle vertex-fetch path at
:57-133): the analytic-sphere fast path and the Möller-Trumbore instance
path are merged by closest t into one HitSurface, and alpha-tested hits are
rejected by re-tracing past them (a bounded number of rounds — the
SIMD-friendly form of the anyhit continuation loop).

Hit-index space: [0, K) sphere instances, [K, K+M) mesh instances — both
resolve through the same packed object table (models/scene.py), so motion
vectors, materials, and emission work identically for both geometries.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models import scene as scene_mod
from ..utils import math as m
from . import intersect, shading, trimesh


def _where_nd(mask, a, b):
    return jnp.where(mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)),
                     a, b)


def _closest_hit(scene, origin, direction, t_min, t_max, block_size):
    """Spheres + mesh instances, merged by closest t. Returns
    (SphereHit-with-combined-index, TriHit | None)."""
    if scene.center.shape[0] == 0:
        # All-mesh scene (models/myscene.as_mesh_scene): no sphere sweep.
        lead = origin.shape[:-1]
        hit = intersect.SphereHit(
            hit=jnp.zeros(lead, bool), t=jnp.full(lead, jnp.inf),
            index=jnp.zeros(lead, jnp.int32), position=origin,
            normal=jnp.zeros_like(origin),
            is_front_face=jnp.zeros(lead, bool))
    else:
        hit = intersect.intersect_spheres(origin, direction, t_min, t_max,
                                          scene.center, scene.radius,
                                          block_size, attributes=False)
    if scene.mesh is None:
        return hit, None
    mi = scene.mesh_instances
    k = scene.center.shape[0]
    # Mesh hits only count when closer than the best sphere hit.
    bound = jnp.where(hit.hit, hit.t, jnp.broadcast_to(t_max, hit.t.shape))
    tri = trimesh.intersect_instances(origin, direction,
                                      jnp.broadcast_to(t_min, hit.t.shape),
                                      bound, scene.mesh, mi.center,
                                      mi.rotation, mi.scale)
    t = jnp.where(tri.hit, tri.t, hit.t)
    idx = jnp.where(tri.hit, k + tri.instance, hit.index)
    any_hit = hit.hit | tri.hit
    t_safe = jnp.where(jnp.isfinite(t), t, 0.0)
    position = origin + direction * t_safe[..., None]
    merged = intersect.SphereHit(
        hit=any_hit, t=t, index=idx, position=position,
        normal=jnp.zeros_like(position),
        is_front_face=jnp.zeros_like(any_hit))
    return merged, tri


def _surface_of(scene, hit, tri, ray_direction, table):
    """HitSurface for the merged hit; mesh lanes get interpolated vertex
    attributes (HitInfo::Initialize for triangles,
    Shaders/HitInfo.hlsli:63-80)."""
    surf = scene_mod.surface_attributes(scene, hit, ray_direction, table)
    if tri is None:
        return surf
    mi = scene.mesh_instances
    n_sh, uv_m, tan_m = trimesh.interpolate_attributes(scene.mesh, tri,
                                                       mi.rotation)
    # Geometric (face) normal for self-intersection avoidance.
    e1 = scene.mesh.e1[tri.face]
    e2 = scene.mesh.e2[tri.face]
    rot = mi.rotation[tri.instance]
    gn = m.normalize(m.quat_rotate(rot, jnp.cross(e1, e2)))
    is_front = m.dot(gn, ray_direction) < 0.0
    n_sh = jnp.where(m.dot(n_sh, ray_direction)[..., None] < 0.0, n_sh,
                     -n_sh)
    mm = tri.hit
    surf = surf.replace(
        geometric_normal=_where_nd(mm, gn, surf.geometric_normal),
        shading_normal=_where_nd(mm, n_sh, surf.shading_normal),
        tangent=_where_nd(mm, tan_m, surf.tangent),
        uv=_where_nd(mm, uv_m, surf.uv),
        is_front_face=jnp.where(mm, is_front, surf.is_front_face))
    if scene.mesh.vertex_motion is not None:
        # Deforming-mesh motion (GBufferGeneration.hlsl:62-91): interpolate
        # per-vertex prev-minus-current object motion at the hit bary and
        # scale to world units in the current pose's object axes (the
        # instance rotation is applied by the G-buffer's prev-pose
        # reconstruction, matching PreviousObjectToWorld).
        tri_idx = scene.mesh.faces[tri.face]
        w0 = 1.0 - tri.barycentrics[..., 0] - tri.barycentrics[..., 1]
        bary = jnp.stack([w0, tri.barycentrics[..., 0],
                          tri.barycentrics[..., 1]], axis=-1)[..., None]
        vm = jnp.sum(scene.mesh.vertex_motion[tri_idx] * bary, axis=-2)
        vm = vm * mi.scale[tri.instance][..., None]
        surf = surf.replace(prev_offset=_where_nd(mm, vm,
                                                  jnp.zeros_like(vm)))
    return surf


def trace_scene(scene, origin, direction, t_min, t_max,
                block_size: int = 16384, table=None,
                alpha_rounds: int = 0) -> scene_mod.HitSurface:
    """Closest-hit against the whole scene -> shading-ready HitSurface.

    ``alpha_rounds`` > 0 enables alpha-tested transparency (IsOpaque,
    /root/reference/Shaders/ShadingHelpers.hlsli:105-159): hits whose
    textured alpha falls below the material cutoff are discarded and the
    ray re-traced from just past them, up to that many rounds.
    """
    if table is None:
        table = scene_mod.object_table(scene)
    hit, tri = _closest_hit(scene, origin, direction, t_min, t_max,
                            block_size)
    surf = _surface_of(scene, hit, tri, direction, table)

    for _ in range(alpha_rounds):
        alpha = surf.material.base_color[..., 3]
        if scene.textures is not None:
            ts = shading.sample_packed(scene.textures,
                                       surf.material.base_color_map,
                                       surf.uv, "nearest0")
            alpha = alpha * ts.alpha
        rejected = surf.valid & (alpha < surf.material.alpha_cutoff)
        t_min2 = jnp.where(rejected,
                           surf.distance * (1.0 + 1e-4) + 1e-4, 0.0)
        t_max2 = jnp.where(rejected,
                           jnp.broadcast_to(t_max, rejected.shape), -1.0)
        hit2, tri2 = _closest_hit(scene, origin, direction, t_min2, t_max2,
                                  block_size)
        surf2 = _surface_of(scene, hit2, tri2, direction, table)
        surf = _merge_surface(rejected, surf2, surf)
    return surf


def _merge_surface(mask, a, b):
    import jax
    return jax.tree.map(lambda x, y: _where_nd(mask, x, y), a, b)


def occluded_scene(scene, origin, direction, max_dist, exclude_index,
                   block_size: int):
    """Conservative any-hit visibility against spheres AND mesh instances
    (RAB_GetConservativeVisibility — alpha-tested surfaces count as
    occluders, matching the reference's conservative mode)."""
    if scene.center.shape[0] == 0:
        occ = jnp.zeros(max_dist.shape, bool)
    else:
        occ = intersect.intersect_spheres_any(
            origin, direction, jnp.zeros(max_dist.shape), max_dist,
            scene.center, scene.radius, block_size,
            exclude_index=exclude_index)
    if scene.mesh is not None:
        mi = scene.mesh_instances
        occ = occ | trimesh.intersect_instances_any(
            origin, direction, jnp.zeros(max_dist.shape), max_dist,
            scene.mesh, mi.center, mi.rotation, mi.scale)
    return occ
