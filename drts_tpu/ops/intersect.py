"""Ray-scene intersection.

Replaces DXR acceleration-structure traversal
(/root/reference/Shaders/RaytracingHelpers.hlsli:7-55 ``TraceRay`` /
RayQuery): the demo scene is sphere instances of one geosphere mesh
(SURVEY.md §7 "sphere fast path"), so the primary test is an analytic
ray-sphere root against *all* instances. On the GPU it runs as the Pallas
kernels of `ops/sphere_kernel.py`; elsewhere as the XLA formulation below
(rays in fixed-size `lax.scan` blocks so the (block x spheres) working set
stays bounded), which is also the tests' reference.

A triangle-mesh path lives in `ops/trimesh.py` for general geometry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import math as m
from ..utils import struct

INF = jnp.float32(jnp.inf)


def _on_gpu() -> bool:
    return jax.default_backend() == "gpu"


@struct.dataclass
class SphereHit:
    """Per-ray hit record (the reference's HitInfo, Shaders/HitInfo.hlsli)."""
    hit: jnp.ndarray        # (...,) bool
    t: jnp.ndarray          # (...,) distance (inf on miss)
    index: jnp.ndarray      # (...,) int32 sphere/instance index (0 on miss)
    position: jnp.ndarray   # (..., 3) world hit position
    normal: jnp.ndarray     # (..., 3) outward geometric normal (unit)
    is_front_face: jnp.ndarray  # (...,) bool: ray hit from outside


def _block_roots(o, d, t_min, t_max, centers, radii_sq, cc_rr):
    """(B, K) hit distances of a ray block against all spheres (inf where
    no root lies in [t_min, t_max]).

    o, d: (B, 3); t_min/t_max: (B,); centers: (K, 3);
    radii_sq: (K,) = r^2; cc_rr: (K,) = |c|^2 - r^2.
    The quadratic's coefficients come from elementwise rank-1 products,
    not a matmul: an f32 matmul may run at reduced precision (TF32 on the
    GPU), which corrupts the cancellation-sensitive terms.
    """
    od = m.dot(o, d)                             # (B,)
    oo = m.dot(o, o)                             # (B,)
    d_dot_c = (d[:, 0:1] * centers[None, :, 0]
               + d[:, 1:2] * centers[None, :, 1]
               + d[:, 2:3] * centers[None, :, 2])  # (B, K)
    o_dot_c = (o[:, 0:1] * centers[None, :, 0]
               + o[:, 1:2] * centers[None, :, 1]
               + o[:, 2:3] * centers[None, :, 2])  # (B, K)
    b = od[:, None] - d_dot_c                    # (B, K) = dot(o - c, d)
    c0 = oo[:, None] - 2.0 * o_dot_c + cc_rr[None, :]
    disc = b * b - c0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    # Take the near root unless it is before t_min (ray starts inside).
    t = jnp.where(t0 >= t_min[:, None], t0, t1)
    valid = (disc > 0.0) & (t >= t_min[:, None]) & (t <= t_max[:, None])
    return jnp.where(valid, t, INF)


def _block_intersect(o, d, t_min, t_max, centers, radii_sq, cc_rr):
    """Closest hit of a ray block: (t (B,), index (B,) int32)."""
    t = _block_roots(o, d, t_min, t_max, centers, radii_sq, cc_rr)
    best = jnp.argmin(t, axis=-1)
    t_best = jnp.take_along_axis(t, best[:, None], axis=-1)[:, 0]
    return t_best, best.astype(jnp.int32)


def _block_occluded(o, d, t_min, t_max, excl, centers, radii_sq, cc_rr):
    """Any hit of a ray block, ignoring sphere excl[i] for ray i."""
    t = _block_roots(o, d, t_min, t_max, centers, radii_sq, cc_rr)
    k = jnp.arange(centers.shape[0], dtype=jnp.int32)
    return jnp.any((t < INF) & (k[None, :] != excl[:, None]), axis=-1)


def _flat_rays(origin, direction, t_min, t_max):
    lead = origin.shape[:-1]
    n = 1
    for s in lead:
        n *= s
    return (origin.reshape(n, 3), direction.reshape(n, 3),
            jnp.broadcast_to(t_min, lead).reshape(n),
            jnp.broadcast_to(t_max, lead).reshape(n))


def _blocked(fn, block_size: int, rays, centers, radii):
    """Map `fn(block rays..., centers, radii_sq, cc_rr)` over fixed-size
    ray blocks (padded rays have t_max < t_min and never hit)."""
    n = rays[0].shape[0]
    radii_sq = radii * radii
    cc_rr = m.dot(centers, centers) - radii_sq
    block = min(block_size, n)
    pad = (-n) % block
    if pad:
        fill = (0.0, 1.0, 0.0, -1.0) + (-1,) * (len(rays) - 4)
        rays = tuple(
            jnp.concatenate([x, jnp.full((pad,) + x.shape[1:], v, x.dtype)])
            for x, v in zip(rays, fill))
    num_blocks = (n + pad) // block
    blocks = tuple(x.reshape((num_blocks, block) + x.shape[1:])
                   for x in rays)

    def body(_, blk):
        return None, fn(*blk, centers, radii_sq, cc_rr)

    if num_blocks == 1:
        out = body(None, tuple(x[0] for x in blocks))[1]
    else:
        _, out = jax.lax.scan(body, None, blocks)
    return jax.tree.map(lambda x: x.reshape(-1)[:n], out)


def intersect_spheres(origin, direction, t_min, t_max, centers, radii,
                      block_size: int = 16384, attributes: bool = True):
    """Closest-hit of rays against all spheres (brute force).

    origin/direction: (..., 3); t_min/t_max broadcastable to (...,).
    centers: (K, 3); radii: (K,). Returns a SphereHit with leading shape
    (...). `block_size` bounds the XLA path's (block x K) working set.
    With attributes=False the normal/front-face fields are left zeroed —
    callers that go through `surface_attributes` (which derives them from
    the packed object table) pass False to skip a redundant gather.
    """
    lead_shape = origin.shape[:-1]
    rays = _flat_rays(origin, direction, t_min, t_max)
    if _on_gpu():
        from . import sphere_kernel
        t_best, idx = sphere_kernel.closest_hit(*rays, centers, radii)
    else:
        t_best, idx = _blocked(_block_intersect, block_size, rays, centers,
                               radii)
    return _make_hit(origin, direction, t_best.reshape(lead_shape),
                     idx.reshape(lead_shape), centers, attributes)


def _make_hit(origin, direction, t_best, idx, centers,
              attributes: bool = True) -> SphereHit:
    hit = jnp.isfinite(t_best)
    t_safe = jnp.where(hit, t_best, 0.0)
    position = origin + direction * t_safe[..., None]
    if attributes:
        center_at = centers[idx]
        normal = m.normalize(position - center_at)
        is_front = m.dot(normal, direction) < 0.0
    else:
        normal = jnp.zeros_like(position)
        is_front = jnp.zeros_like(hit)
    return SphereHit(hit=hit, t=t_best, index=idx, position=position,
                     normal=normal, is_front_face=is_front)


def intersect_spheres_any(origin, direction, t_min, t_max, centers, radii,
                          block_size: int = 16384, exclude_index=None):
    """Any-hit (shadow/visibility ray) — boolean occlusion, optionally
    ignoring one object per ray (the target light itself).

    The reference issues these via
    RAY_FLAG_ACCEPT_FIRST_HIT_AND_END_SEARCH for ReSTIR visibility
    (Shaders/RTXDIAppBridge.hlsli:418-459): a ray is occluded when any
    sphere other than its excluded one has a root in [t_min, t_max].
    """
    lead_shape = origin.shape[:-1]
    rays = _flat_rays(origin, direction, t_min, t_max)
    excl = (jnp.full(rays[2].shape, -1, jnp.int32) if exclude_index is None
            else jnp.broadcast_to(exclude_index, lead_shape).reshape(-1)
            .astype(jnp.int32))
    if _on_gpu():
        from . import sphere_kernel
        occ = sphere_kernel.any_hit(*rays, centers, radii, excl)
    else:
        occ = _blocked(_block_occluded, block_size, rays + (excl,), centers,
                       radii)
    return occ.reshape(lead_shape)


def safe_spawn_point(position, flat_normal, direction, scale=None):
    """Offset a secondary-ray origin off the surface along the geometric
    normal, signed by travel direction — the analytic-sphere analogue of
    SelfIntersectionAvoidance::OffsetSpawnPoint
    (/root/reference/Shaders/SelfIntersectionAvoidance.hlsli:39-117,
    HitInfo::GetSafeWorldRayOrigin). For analytic spheres a magnitude-scaled
    epsilon suffices (no triangle reconstruction error to bound)."""
    eps = 1e-4 * jnp.maximum(1.0, m.length(position, keepdims=True))
    if scale is not None:
        eps = eps * scale
    side = m.sign_not_zero(m.dot(direction, flat_normal))[..., None]
    return position + flat_normal * side * eps
