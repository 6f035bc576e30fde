"""Triangle-mesh intersection with instancing: the general-geometry path.

Analogue of the reference's BLAS/TLAS triangle pipeline
(/root/reference/Source/RaytracingHelpers.ixx:28-105 geometry/instance
descs; device-side vertex fetch + interpolation in
Shaders/RaytracingHelpers.hlsli:57-133 ``CastRay``). The demo scene runs on
the analytic-sphere fast path (ops/intersect.py); this module provides
capability parity for arbitrary triangle geometry:

- one shared mesh (the reference instances a single geosphere BLAS,
  Scene.ixx:225-284) with per-instance rigid transforms,
- a two-level test: a loop over instances with a bounding-sphere cull,
  then Möller-Trumbore over Morton-ordered triangle blocks in object
  space — dense masked sweeps,
- barycentric attribute interpolation (normals, UVs, tangents) matching
  HitInfo::Initialize (Shaders/HitInfo.hlsli:63-80).

Every ray is tested against every instance's triangles (no traversal
structure yet), so cost grows with instances x faces.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..utils import math as m

INF = jnp.float32(jnp.inf)


@struct.dataclass
class TriMesh:
    """Shared triangle mesh, SoA (the Mesh vertex/index buffers,
    Source/Model.ixx:45). Faces are stored in Morton (centroid) order —
    make_mesh permutes them at build — so each face block of the sweep
    covers a compact patch of the surface."""
    positions: jnp.ndarray  # (V, 3)
    normals: jnp.ndarray    # (V, 3)
    uvs: jnp.ndarray        # (V, 2)
    tangents: jnp.ndarray   # (V, 3)
    faces: jnp.ndarray      # (F, 3) int32
    # Precomputed per-face corners for the intersection sweep.
    v0: jnp.ndarray         # (F, 3)
    e1: jnp.ndarray         # (F, 3) v1 - v0
    e2: jnp.ndarray         # (F, 3) v2 - v0
    bound_radius: jnp.ndarray  # scalar: mesh-space bounding radius
    # Optional per-vertex motion (V, 3): previous - current OBJECT-space
    # position per vertex (deforming meshes; the reference's optional
    # vertex-motion G-buffer path, GBufferGeneration.hlsl:62-91
    # CalculateMotionVector meshMotionVectors). None = rigid.
    vertex_motion: jnp.ndarray = None


def _morton3(x: np.ndarray) -> np.ndarray:
    """30-bit Morton code from (N, 3) integer coordinates in [0, 1024)."""
    def spread(v):
        v = v.astype(np.uint64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return (spread(x[:, 0]) | (spread(x[:, 1]) << 1)
            | (spread(x[:, 2]) << 2))


def morton_face_order(v0, e1, e2) -> np.ndarray:
    """(F,) face permutation sorting triangle centroids along a Morton
    curve (host-side, once per mesh)."""
    cent = v0 + (e1 + e2) / 3.0
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-9)
    quant = np.clip((cent - lo) / span * 1023.0, 0, 1023).astype(np.uint64)
    return np.argsort(_morton3(quant), kind="stable").astype(np.int32)


def make_mesh(positions, normals, uvs, faces, tangents=None,
              vertex_motion=None) -> TriMesh:
    positions = jnp.asarray(positions, jnp.float32)
    faces = jnp.asarray(faces, jnp.int32)
    if tangents is None:
        from ..models import geometry
        tangents = geometry.compute_tangent_frame(
            np.asarray(faces), np.asarray(positions),
            np.asarray(normals), np.asarray(uvs))
    v0 = positions[faces[:, 0]]
    v1 = positions[faces[:, 1]]
    v2 = positions[faces[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    order = jnp.asarray(morton_face_order(np.asarray(v0), np.asarray(e1),
                                          np.asarray(e2)))
    return TriMesh(
        positions=positions,
        normals=jnp.asarray(normals, jnp.float32),
        uvs=jnp.asarray(uvs, jnp.float32),
        tangents=jnp.asarray(tangents, jnp.float32),
        faces=faces[order],
        v0=v0[order], e1=e1[order], e2=e2[order],
        bound_radius=jnp.max(m.length(positions)),
        vertex_motion=(None if vertex_motion is None
                       else jnp.asarray(vertex_motion, jnp.float32)))


@struct.dataclass
class TriHit:
    hit: jnp.ndarray        # (...,) bool
    t: jnp.ndarray          # (...,)
    face: jnp.ndarray       # (...,) int32
    instance: jnp.ndarray   # (...,) int32
    barycentrics: jnp.ndarray  # (..., 2) (u, v) of v1/v2


def _moller_trumbore(o, d, v0, e1, e2, t_min, t_max, eps=1e-8):
    """Batched Möller-Trumbore: rays (B, 3) × triangles (F, 3) -> (B, F)
    hit t / barycentrics. Memory O(B * F); callers block over both."""
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])          # (B, F, 3)
    det = jnp.sum(pvec * e1[None], axis=-1)                  # (B, F)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tvec = o[:, None, :] - v0[None]                          # (B, F, 3)
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None])
    v = jnp.sum(qvec * d[:, None, :], axis=-1) * inv_det
    t = jnp.sum(qvec * e2[None], axis=-1) * inv_det
    valid = ((jnp.abs(det) > eps) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= t_min[:, None])
             & (t <= t_max[:, None]))
    return jnp.where(valid, t, INF), u, v


def intersect_mesh(origin, direction, t_min, t_max, mesh: TriMesh,
                   ray_block: int = 65536, face_block: int = 512):
    """Closest-hit against one mesh in its own space. Shapes as in
    ops/intersect.intersect_spheres. Returns (t, face, u, v).

    Rays go in blocks of `ray_block`, faces in blocks of `face_block`
    (clamped to the mesh): each step tests a (ray block x face block)
    tile, so the step count, not the tile, is what grows with the scene.
    """
    lead = origin.shape[:-1]
    n = int(np.prod(lead)) if lead else 1
    o = origin.reshape(n, 3)
    d = direction.reshape(n, 3)
    tmin = jnp.broadcast_to(t_min, lead).reshape(n)
    tmax = jnp.broadcast_to(t_max, lead).reshape(n)

    f = mesh.v0.shape[0]
    face_block = min(face_block, f)
    fpad = (-f) % face_block
    # Padded faces are degenerate (zero edges): det = 0, never hit.
    v0 = jnp.pad(mesh.v0, ((0, fpad), (0, 0)))
    e1 = jnp.pad(mesh.e1, ((0, fpad), (0, 0)))
    e2 = jnp.pad(mesh.e2, ((0, fpad), (0, 0)))
    nf = f + fpad

    ray_block = min(ray_block, n)
    rpad = (-n) % ray_block
    o = jnp.pad(o, ((0, rpad), (0, 0)))
    d = jnp.pad(d, ((0, rpad), (0, 0)), constant_values=1.0)
    tmin = jnp.pad(tmin, (0, rpad))
    tmax = jnp.pad(tmax, (0, rpad), constant_values=-1.0)

    def ray_blk(carry_blk):
        ob, db, tminb, tmaxb = carry_blk

        def face_blk(c, best):
            best_t, best_f, best_u, best_v = best
            s = c * face_block
            t, u, v = _moller_trumbore(
                ob, db, jax.lax.dynamic_slice_in_dim(v0, s, face_block),
                jax.lax.dynamic_slice_in_dim(e1, s, face_block),
                jax.lax.dynamic_slice_in_dim(e2, s, face_block),
                tminb, tmaxb)
            tb = jnp.min(t, axis=-1)
            arg = jnp.argmin(t, axis=-1)
            ub = jnp.take_along_axis(u, arg[:, None], axis=-1)[:, 0]
            vb = jnp.take_along_axis(v, arg[:, None], axis=-1)[:, 0]
            closer = tb < best_t
            return (jnp.where(closer, tb, best_t),
                    jnp.where(closer, arg.astype(jnp.int32) + s, best_f),
                    jnp.where(closer, ub, best_u),
                    jnp.where(closer, vb, best_v))

        b = ob.shape[0]
        init = (jnp.full((b,), INF), jnp.zeros((b,), jnp.int32),
                jnp.zeros((b,)), jnp.zeros((b,)))
        return jax.lax.fori_loop(0, nf // face_block, face_blk, init)

    blocks = (o.reshape(-1, ray_block, 3), d.reshape(-1, ray_block, 3),
              tmin.reshape(-1, ray_block), tmax.reshape(-1, ray_block))
    if blocks[0].shape[0] == 1:
        t, face, u, v = ray_blk(jax.tree.map(lambda x: x[0], blocks))
    else:
        _, out = jax.lax.scan(lambda _, b: (None, ray_blk(b)), None, blocks)
        t, face, u, v = (x.reshape(-1) for x in out)
    t = t[:n].reshape(lead)
    face = jnp.minimum(face[:n], f - 1).reshape(lead)
    return t, face, u[:n].reshape(lead), v[:n].reshape(lead)


def _instance_step(best: TriHit, i, origin, direction, t_min, t_max,
                   mesh: TriMesh, inst_position, inst_rotation, inst_scale,
                   **kw) -> TriHit:
    """Fold instance i into the running closest hit."""
    # Bounding-sphere early-out: rays that cannot reach this instance's
    # bound closer than their current best hit get a dead t-range.
    oc = origin - inst_position[i]
    b_q = m.dot(oc, direction)
    r_w = mesh.bound_radius * inst_scale[i]
    c_q = m.dot(oc, oc) - r_w * r_w
    disc = b_q * b_q - c_q
    t_near = -b_q - jnp.sqrt(jnp.maximum(disc, 0.0))
    reachable = (disc > 0.0) & (t_near <= jnp.minimum(t_max, best.t)) \
        & ((-b_q + jnp.sqrt(jnp.maximum(disc, 0.0))) >= t_min)
    t_max_i = jnp.where(reachable, jnp.minimum(t_max, best.t), t_min - 1.0)

    inv_rot = m.quat_conj(inst_rotation[i])
    o_l = m.quat_rotate(inv_rot, oc) / inst_scale[i]
    # Unnormalized d_l keeps t in world units.
    d_l = m.quat_rotate(inv_rot, direction) / inst_scale[i]
    t, face, u, v = intersect_mesh(o_l, d_l, t_min, t_max_i, mesh, **kw)
    closer = t < best.t
    return TriHit(
        hit=best.hit | (closer & jnp.isfinite(t)),
        t=jnp.where(closer, t, best.t),
        face=jnp.where(closer, face, best.face),
        instance=jnp.where(closer, i, best.instance),
        barycentrics=jnp.where(closer[..., None],
                               jnp.stack([u, v], axis=-1),
                               best.barycentrics))


def _no_hit(lead) -> TriHit:
    return TriHit(hit=jnp.zeros(lead, bool), t=jnp.full(lead, INF),
                  face=jnp.zeros(lead, jnp.int32),
                  instance=jnp.zeros(lead, jnp.int32),
                  barycentrics=jnp.zeros(lead + (2,)))


def intersect_instances(origin, direction, t_min, t_max, mesh: TriMesh,
                        inst_position, inst_rotation, inst_scale,
                        **kw) -> TriHit:
    """Two-level closest hit: per instance, cull by bounding sphere,
    transform the ray to object space, test triangles, keep the closest
    (the TLAS->BLAS dispatch, RaytracingHelpers.hlsli TraceRay analogue).
    Instances run in order under one `lax.fori_loop`, so the program size
    does not grow with the instance count."""
    t_min = jnp.broadcast_to(t_min, origin.shape[:-1])
    t_max = jnp.broadcast_to(t_max, origin.shape[:-1])

    def body(i, best):
        return _instance_step(best, i, origin, direction, t_min, t_max,
                              mesh, inst_position, inst_rotation, inst_scale,
                              **kw)

    return jax.lax.fori_loop(0, inst_position.shape[0], body,
                             _no_hit(origin.shape[:-1]))


def intersect_instances_any(origin, direction, t_min, t_max, mesh: TriMesh,
                            inst_position, inst_rotation, inst_scale):
    """Any-hit occlusion against instanced meshes (the mesh half of
    RAY_FLAG_ACCEPT_FIRST_HIT_AND_END_SEARCH visibility rays,
    RTXDIAppBridge.hlsli:418-459): the closest-hit sweep's hit bit."""
    return intersect_instances(origin, direction, t_min, t_max, mesh,
                               inst_position, inst_rotation,
                               inst_scale).hit


def interpolate_attributes(mesh: TriMesh, hit: TriHit, inst_rotation):
    """Vertex fetch + barycentric interpolation (Vertex::Interpolate /
    HitInfo::Initialize, Shaders/{Vertex,HitInfo}.hlsli), rotated to world.
    Returns (normal, uv, tangent)."""
    tri = mesh.faces[hit.face]                          # (..., 3)
    w = 1.0 - hit.barycentrics[..., 0] - hit.barycentrics[..., 1]
    bary = jnp.stack([w, hit.barycentrics[..., 0],
                      hit.barycentrics[..., 1]], axis=-1)[..., None]

    def interp(attr):
        return jnp.sum(attr[tri] * bary, axis=-2)

    rot = inst_rotation[hit.instance]
    normal = m.normalize(m.quat_rotate(rot, interp(mesh.normals)))
    tangent = m.normalize(m.quat_rotate(rot, interp(mesh.tangents)))
    return normal, interp(mesh.uvs), tangent
