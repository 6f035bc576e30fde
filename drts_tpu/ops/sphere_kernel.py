"""Ray-sphere closest-hit and any-hit as Pallas kernels (Triton route).

The GPU form of `intersect._block_intersect` / `_block_occluded`: one
program takes RAY_BLOCK rays and walks the sphere table in SPHERE_TILE
slices, keeping the running (t, index) in registers, so the
(rays x spheres) root matrix never reaches device memory. The root
formula is the XLA path's (exact f32 roots, no truncated encoding).

Padding never hits: padded rays carry t_max = -1 < t_min = 0, padded
spheres carry |c|^2 - r^2 = 1e30 (no real root). Ties keep the lowest
sphere index, as `argmin` does.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Tuned on an H100 at 4.1M rays x 438 spheres (PERF.md): small sphere
# tiles keep the elementwise (ray, slot) carry in registers.
RAY_BLOCK = 64
SPHERE_TILE = 8
NUM_WARPS = 4
_NO_ROOT = 1e30
_BIG_INDEX = 1 << 30


def _rays_planar(o, d, tmin, tmax):
    """(n, 3) rays -> (8, n_pad) planar rows [o d tmin tmax]."""
    n = o.shape[0]
    n_pad = -(-n // RAY_BLOCK) * RAY_BLOCK
    rows = jnp.concatenate([o.T, d.T, tmin[None], tmax[None]]).astype(
        jnp.float32)
    if n_pad != n:
        pad = jnp.zeros((8, n_pad - n), jnp.float32).at[7].set(-1.0)
        rows = jnp.concatenate([rows, pad], axis=1)
    return rows


def _spheres_planar(centers, radii):
    """(K, 3), (K,) -> (4, K_pad) rows [cx cy cz |c|^2-r^2], K_pad a power
    of two (Triton block shapes), and the number of live tiles."""
    k = centers.shape[0]
    k_pad = max(SPHERE_TILE, pl.next_power_of_2(k))
    cc_rr = (centers[:, 0] * centers[:, 0] + centers[:, 1] * centers[:, 1]
             + centers[:, 2] * centers[:, 2]) - radii * radii
    rows = jnp.concatenate([centers.T, cc_rr[None]]).astype(jnp.float32)
    pad = jnp.zeros((4, k_pad - k), jnp.float32).at[3].set(_NO_ROOT)
    return jnp.concatenate([rows, pad], axis=1), -(-k // SPHERE_TILE)


def _tile_roots(rays, sph_ref, j):
    """(RAY_BLOCK, SPHERE_TILE) hit distances (inf = no valid root) and the
    tile's global sphere indices."""
    ox, oy, oz, dx, dy, dz, tmin, tmax, od, oo = rays
    sl = pl.ds(j * SPHERE_TILE, SPHERE_TILE)
    cx = sph_ref[0, sl][None, :]
    cy = sph_ref[1, sl][None, :]
    cz = sph_ref[2, sl][None, :]
    cc_rr = sph_ref[3, sl][None, :]
    d_dot_c = dx[:, None] * cx + dy[:, None] * cy + dz[:, None] * cz
    o_dot_c = ox[:, None] * cx + oy[:, None] * cy + oz[:, None] * cz
    b = od[:, None] - d_dot_c
    c0 = oo[:, None] - 2.0 * o_dot_c + cc_rr
    disc = b * b - c0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where(t0 >= tmin[:, None], t0, t1)
    valid = (disc > 0.0) & (t >= tmin[:, None]) & (t <= tmax[:, None])
    idx = j * SPHERE_TILE + jnp.arange(SPHERE_TILE, dtype=jnp.int32)[None, :]
    return jnp.where(valid, t, jnp.inf), idx


def _load_rays(rays_ref):
    ox, oy, oz = rays_ref[0, :], rays_ref[1, :], rays_ref[2, :]
    dx, dy, dz = rays_ref[3, :], rays_ref[4, :], rays_ref[5, :]
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    return ox, oy, oz, dx, dy, dz, rays_ref[6, :], rays_ref[7, :], od, oo


def _closest_kernel(rays_ref, sph_ref, t_ref, i_ref, *, n_tiles: int):
    rays = _load_rays(rays_ref)

    # Elementwise running best per (ray, tile slot): the loop body has no
    # cross-lane reduction; one reduction over the slots at the end.
    def body(j, carry):
        best_t, best_i = carry
        t, idx = _tile_roots(rays, sph_ref, j)
        closer = t < best_t          # strict: ties keep the lower index
        return jnp.where(closer, t, best_t), jnp.where(closer, idx, best_i)

    init = (jnp.full((RAY_BLOCK, SPHERE_TILE), jnp.inf, jnp.float32),
            jnp.zeros((RAY_BLOCK, SPHERE_TILE), jnp.int32))
    best_t, best_i = jax.lax.fori_loop(0, n_tiles, body, init)
    t_min = jnp.min(best_t, axis=1)
    t_ref[...] = t_min
    i_ref[...] = jnp.min(jnp.where(best_t == t_min[:, None], best_i,
                                   _BIG_INDEX), axis=1)


def _any_kernel(rays_ref, excl_ref, sph_ref, occ_ref, *, n_tiles: int):
    rays = _load_rays(rays_ref)
    excl = excl_ref[...]

    # Elementwise OR per (ray, tile slot), reduced once at the end. A
    # per-tile "whole block occluded" early exit measured slower: its
    # cross-lane reduction costs more than the tiles it skips.
    def body(j, occ):
        t, idx = _tile_roots(rays, sph_ref, j)
        hit = (t < jnp.inf) & (idx != excl[:, None])
        return occ | hit.astype(jnp.int32)

    occ = jax.lax.fori_loop(0, n_tiles, body,
                            jnp.zeros((RAY_BLOCK, SPHERE_TILE), jnp.int32))
    occ_ref[...] = jnp.max(occ, axis=1)


def _call(kernel, name, out_shape, n_pad, k_pad, n_in_rows, interpret):
    ray_spec = pl.BlockSpec((8, RAY_BLOCK), lambda i: (0, i))
    lane_spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    in_specs = [ray_spec] + [lane_spec] * n_in_rows + [
        pl.BlockSpec((4, k_pad), lambda i: (0, 0))]
    return pl.pallas_call(
        kernel, out_shape=out_shape, grid=(n_pad // RAY_BLOCK,),
        in_specs=in_specs,
        out_specs=jax.tree.map(lambda _: lane_spec, out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret, name=name)


@functools.partial(jax.jit, static_argnames=("interpret",))
def closest_hit(o, d, tmin, tmax, centers, radii, interpret: bool = False):
    """(n, 3) rays against K spheres -> (t (n,) f32, inf on miss;
    index (n,) int32, 0 on miss)."""
    n = o.shape[0]
    rays = _rays_planar(o, d, tmin, tmax)
    sph, n_tiles = _spheres_planar(centers, radii)
    n_pad = rays.shape[1]
    out_shape = (jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                 jax.ShapeDtypeStruct((n_pad,), jnp.int32))
    t, idx = _call(functools.partial(_closest_kernel, n_tiles=n_tiles),
                   "sphere_closest_hit", out_shape, n_pad, sph.shape[1], 0,
                   interpret)(rays, sph)
    return t[:n], idx[:n]


@functools.partial(jax.jit, static_argnames=("interpret",))
def any_hit(o, d, tmin, tmax, centers, radii, exclude,
            interpret: bool = False):
    """(n,) bool: some sphere other than exclude[i] (-1 = none) has a root
    in [tmin, tmax]."""
    n = o.shape[0]
    rays = _rays_planar(o, d, tmin, tmax)
    sph, n_tiles = _spheres_planar(centers, radii)
    n_pad = rays.shape[1]
    excl = jnp.full((n_pad,), -1, jnp.int32).at[:n].set(
        exclude.astype(jnp.int32))
    out_shape = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
    occ = _call(functools.partial(_any_kernel, n_tiles=n_tiles),
                "sphere_any_hit", out_shape, n_pad, sph.shape[1], 1,
                interpret)(rays, excl, sph)
    return occ[:n] > 0
