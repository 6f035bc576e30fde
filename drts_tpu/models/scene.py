"""Scene representation: sphere instances + materials + environment.

Reimplementation of the reference's Source/Scene.ixx: instead of
BLAS/TLAS handles and per-instance transform matrices, the scene is a pytree
of SoA arrays — current and previous poses (Scene::Refresh keeps both for
motion vectors, Scene.ixx:185-219), per-instance material parameters, and
the environment light. `advance_pose` is the TLAS-refit analogue: O(K) array
swaps instead of an acceleration-structure rebuild.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from ..utils import struct

from ..ops import sky
from ..utils import math as m
from . import geometry
from .material import Materials


@struct.dataclass
class MeshInstances:
    """Triangle-mesh instances in the scene (the reference's geosphere BLAS
    instancing, Scene.ixx:225-284): rigid transforms + material rows.
    Material rows live at indices [K, K+M) of scene.materials (after the K
    sphere materials), so the combined hit-index space is
    [0, K) spheres | [K, K+M) mesh instances."""
    center: jnp.ndarray         # (M, 3)
    rotation: jnp.ndarray       # (M, 4) quaternion, object->world
    prev_center: jnp.ndarray    # (M, 3)
    prev_rotation: jnp.ndarray  # (M, 4)
    scale: jnp.ndarray          # (M,)


@struct.dataclass
class SphereScene:
    """All scene state a render pass reads (SURVEY.md §1 L2)."""
    # Dynamic pose (written by physics each frame; Scene::Refresh analogue).
    center: jnp.ndarray         # (K, 3)
    rotation: jnp.ndarray       # (K, 4) quaternion, object->world
    prev_center: jnp.ndarray    # (K, 3)
    prev_rotation: jnp.ndarray  # (K, 4)
    # Static shape + materials ((K+M,) arrays when mesh instances exist).
    radius: jnp.ndarray         # (K,)
    materials: Materials
    env: sky.EnvironmentLight
    # Packed texture sets (models/texpack.PackedTextures) or None. One
    # quad-duplicated row gather per hit replaces the reference's 6
    # independent map samples (ShadingHelpers.hlsli:161-235).
    textures: "object | None" = None
    # Optional triangle-mesh content (ops/trimesh.py path).
    mesh: "object | None" = None            # ops.trimesh.TriMesh
    mesh_instances: MeshInstances | None = None
    # Alpha-tested transparency: number of anyhit re-trace rounds
    # (ShadingHelpers.hlsli:105-159 IsOpaque). 0 = all-opaque fast path;
    # scene builders set >0 when any material is alpha-tested. Static so
    # opaque scenes compile with no alpha machinery at all.
    alpha_test_rounds: int = struct.field(pytree_node=False, default=0)

    @property
    def object_count(self) -> int:
        return self.center.shape[0]


def advance_pose(scene: SphereScene, new_center, new_rotation) -> SphereScene:
    """Per-frame pose update, keeping the previous pose for motion vectors —
    the functional form of Scene::Refresh (Scene.ixx:185-219)."""
    return dataclasses.replace(
        scene, prev_center=scene.center, prev_rotation=scene.rotation,
        center=new_center, rotation=new_rotation)


@struct.dataclass
class HitSurface:
    """Shading-ready surface attributes — what CastRay's vertex fetch +
    interpolate produces (Shaders/RaytracingHelpers.hlsli:57-133), computed
    analytically for sphere instances."""
    valid: jnp.ndarray            # (...,) bool
    position: jnp.ndarray         # (..., 3)
    geometric_normal: jnp.ndarray  # (..., 3) outward unit normal
    shading_normal: jnp.ndarray   # (..., 3) front-flipped (HitInfo.hlsli)
    tangent: jnp.ndarray          # (..., 3)
    uv: jnp.ndarray               # (..., 2) lat-long in object space
    is_front_face: jnp.ndarray    # (...,)
    distance: jnp.ndarray         # (...,)
    object_index: jnp.ndarray     # (...,) int32
    material: Materials           # per-ray gathered material
    # Optional (..., 3): previous-minus-current OBJECT-space offset at the
    # hit (interpolated per-vertex motion for deforming meshes, in the
    # CURRENT instance pose's object axes scaled to world units; zeros /
    # None for rigid geometry). Consumed by the G-buffer motion-vector
    # reconstruction (GBufferGeneration.hlsl:62-91 parity).
    prev_offset: jnp.ndarray = None


# Packed per-object attribute table: every per-ray attribute lookup is ONE
# wide row gather from this (K+M, 33) table instead of many narrow ones.
# Columns: 0:3 center | 3 radius | 4:8 rotation | 8:11 prev_center |
# 11:15 prev_rotation | 15:18 base_color rgb | 18 alpha | 19:22 emission |
# 22 metallic | 23 roughness | 24 ior | 25 transmission |
# 26 base_color_map | 27 normal_map | 28 metallic_map | 29 roughness_map |
# 30 alpha_cutoff | 31 emissive_color_map | 32 transmission_map.
# Rows [K, K+M) are mesh instances (radius 0; center/rotation = instance
# transform, so the G-buffer's rigid-motion reprojection works unchanged).


def object_table(scene: SphereScene) -> jnp.ndarray:
    mat = scene.materials
    center, radius = scene.center, scene.radius
    rotation = scene.rotation
    prev_center, prev_rotation = scene.prev_center, scene.prev_rotation
    if scene.mesh_instances is not None:
        mi = scene.mesh_instances
        mcount = mi.center.shape[0]
        center = jnp.concatenate([center, mi.center])
        radius = jnp.concatenate([radius,
                                  jnp.zeros((mcount,), jnp.float32)])
        rotation = jnp.concatenate([rotation, mi.rotation])
        prev_center = jnp.concatenate([prev_center, mi.prev_center])
        prev_rotation = jnp.concatenate([prev_rotation, mi.prev_rotation])
    cols = [
        center, radius[:, None], rotation,
        prev_center, prev_rotation,
        mat.base_color[:, :3], mat.base_color[:, 3:4], mat.emission(),
        mat.metallic[:, None], mat.roughness[:, None], mat.ior[:, None],
        mat.transmission[:, None],
        mat.base_color_map[:, None].astype(jnp.float32),
        mat.normal_map[:, None].astype(jnp.float32),
        mat.metallic_map[:, None].astype(jnp.float32),
        mat.roughness_map[:, None].astype(jnp.float32),
        mat.alpha_cutoff[:, None],
        mat.emissive_color_map[:, None].astype(jnp.float32),
        mat.transmission_map[:, None].astype(jnp.float32),
    ]
    return jnp.concatenate(cols, axis=-1)


def surface_attributes(scene: SphereScene, hit, ray_direction,
                       table: jnp.ndarray | None = None) -> HitSurface:
    """Build shading attributes from a SphereHit (ops/intersect.py).

    Mirrors HitInfo::Initialize (Shaders/HitInfo.hlsli:96-134): the shading
    normal is the geometric normal flipped to face the incoming ray; UV and
    tangent come from the instance-rotated lat-long parametrization (the
    geosphere's UV layout, MyScene.ixx:53-88). All per-object attributes
    come from one packed-table gather.
    """
    if table is None:
        table = object_table(scene)
    row = table[hit.index]                       # the single wide fetch
    center = row[..., 0:3]
    radius = row[..., 3]
    rot = row[..., 4:8]

    # Newton-refine the hit distance: the f32 quadratic root loses bits
    # to cancellation on large spheres far from the ray origin. One Newton
    # step on f(t) = |o + t d - c|^2 - r^2 recovers them; mesh rows carry
    # radius 0 and keep their t.
    p_c = hit.position - center
    f = m.dot(p_c, p_c) - radius * radius
    df = 2.0 * m.dot(ray_direction, p_c)
    refine = hit.hit & (radius > 0.0) & (jnp.abs(df) > 1e-12)
    delta = jnp.where(refine, -f / jnp.where(refine, df, 1.0), 0.0)
    t = hit.t + delta
    position = hit.position + ray_direction * delta[..., None]

    normal = m.normalize(position - center)
    is_front = m.dot(normal, ray_direction) < 0.0
    shading_normal = jnp.where(is_front[..., None], normal, -normal)

    if scene.textures is not None:
        obj_normal = m.quat_rotate(m.quat_conj(rot), normal)
        uv = m.to_latlong(obj_normal)
        tangent = m.quat_rotate(rot, geometry.sphere_tangent(obj_normal))
    else:
        # No texture maps in flight: skip the transcendental-heavy UV math
        # (XLA would keep it live through the outputs otherwise).
        uv = jnp.zeros(hit.t.shape + (2,), jnp.float32)
        tangent, _ = m.orthonormal_basis(shading_normal)

    material = Materials(
        base_color=jnp.concatenate([row[..., 15:18], row[..., 18:19]],
                                   axis=-1),
        emissive_strength=jnp.ones(hit.t.shape, jnp.float32),
        emissive_color=row[..., 19:22],
        metallic=row[..., 22],
        roughness=row[..., 23],
        ior=row[..., 24],
        transmission=row[..., 25],
        alpha_cutoff=row[..., 30],
        base_color_map=row[..., 26].astype(jnp.int32),
        emissive_color_map=row[..., 31].astype(jnp.int32),
        metallic_map=row[..., 28].astype(jnp.int32),
        roughness_map=row[..., 29].astype(jnp.int32),
        normal_map=row[..., 27].astype(jnp.int32),
        transmission_map=row[..., 32].astype(jnp.int32),
    )
    return HitSurface(
        valid=hit.hit,
        position=position,
        geometric_normal=normal,
        shading_normal=shading_normal,
        tangent=tangent,
        uv=uv,
        is_front_face=is_front,
        distance=t,
        object_index=hit.index,
        material=material,
    )
