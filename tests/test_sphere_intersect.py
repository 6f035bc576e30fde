"""Sphere closest hit and any hit against a float64 numpy reference.

The XLA path (ops/intersect.py, what the CPU runs) and the Pallas kernel
of ops/sphere_kernel.py (what the GPU runs; interpret mode here) at ray
counts on both sides of the 64-ray blocks of each. Rays whose result a
few ulps can flip (tangent rays, near ties, roots at the ends of the
range) are left out by the reference's grazing mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import T_TOL, _np_roots
from drts_tpu.ops import intersect, sphere_kernel

K = 37          # not a multiple of the kernel's sphere tile
BLOCK = 64      # XLA path block; the kernel's RAY_BLOCK is 64 too
COUNTS = [1, 63, 64, 65, 130, 700]


def _scene():
    rng = np.random.RandomState(1)
    c = (rng.randn(K, 3) * 4).astype(np.float32)
    r = (0.3 + rng.rand(K)).astype(np.float32)
    c[0], r[0] = (0.0, -1000.0, 0.0), 995.0      # a large ground sphere
    return c, r


def _rays(n, seed=0):
    rng = np.random.RandomState(seed + n)
    o = (rng.randn(n, 3) * 8).astype(np.float32)
    d = rng.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmin = np.where(rng.rand(n) < 0.2, 0.5, 0.0).astype(np.float32)
    u = rng.rand(n)
    tmax = np.where(u < 0.4, np.inf, np.where(u < 0.9, rng.rand(n) * 20,
                                              -1.0)).astype(np.float32)
    excl = rng.randint(-1, K, n).astype(np.int32)
    return o, d, tmin, tmax, excl


def _reference(o, d, tmin, tmax, c, r):
    t, graze = _np_roots(o, d, tmin, tmax, c, r)
    best = t.min(1)
    return t, best, np.where(np.isfinite(best), t.argmin(1), 0), ~graze


def _xla_closest(o, d, tmin, tmax, c, r):
    return intersect._blocked(intersect._block_intersect, BLOCK,
                              (o, d, tmin, tmax), c, r)


def _xla_any(o, d, tmin, tmax, excl, c, r):
    return intersect._blocked(intersect._block_occluded, BLOCK,
                              (o, d, tmin, tmax, excl), c, r)


def _check_closest(t, idx, best, ref_idx, keep):
    t, idx = np.asarray(t), np.asarray(idx)
    hit = np.isfinite(best)
    np.testing.assert_array_equal(np.isfinite(t)[keep], hit[keep])
    np.testing.assert_array_equal(idx[keep], ref_idx[keep])
    both = keep & hit
    np.testing.assert_array_less(
        np.abs(t[both] - best[both]) / np.maximum(best[both], 1.0), T_TOL)


def _any_reference(t_all, excl):
    mask = np.arange(K)[None] != excl[:, None]
    return (np.isfinite(t_all) & mask).any(1)


@pytest.mark.parametrize("n", COUNTS)
def test_xla_closest_hit_matches_float64(n):
    c, r = _scene()
    o, d, tmin, tmax, _ = _rays(n)
    t_all, best, ref_idx, keep = _reference(o, d, tmin, tmax, c, r)
    t, idx = _xla_closest(*map(jnp.asarray, (o, d, tmin, tmax, c, r)))
    assert t.shape == (n,) and idx.dtype == jnp.int32
    _check_closest(t, idx, best, ref_idx, keep)


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("n", COUNTS)
def test_xla_any_hit_matches_float64(n, exclude):
    c, r = _scene()
    o, d, tmin, tmax, excl = _rays(n)
    if not exclude:
        excl = np.full(n, -1, np.int32)
    t_all, _, _, keep = _reference(o, d, tmin, tmax, c, r)
    occ = np.asarray(_xla_any(*map(jnp.asarray,
                                   (o, d, tmin, tmax, excl, c, r))))
    np.testing.assert_array_equal(occ[keep], _any_reference(t_all,
                                                            excl)[keep])
    assert not occ[tmax < tmin].any()


@pytest.mark.parametrize("n", COUNTS)
def test_kernel_interpret_matches_xla(n):
    """The Pallas kernels (interpret mode) agree with the XLA path on
    closest hit and on any hit with and without an excluded sphere."""
    c, r = _scene()
    o, d, tmin, tmax, excl = map(jnp.asarray, _rays(n))
    c, r = jnp.asarray(c), jnp.asarray(r)
    t_all, best, ref_idx, keep = _reference(*map(np.asarray,
                                                 (o, d, tmin, tmax, c, r)))
    t, idx = sphere_kernel.closest_hit(o, d, tmin, tmax, c, r,
                                       interpret=True)
    _check_closest(t, idx, best, ref_idx, keep)
    t_x, idx_x = _xla_closest(o, d, tmin, tmax, c, r)
    np.testing.assert_array_equal(np.asarray(idx)[keep],
                                  np.asarray(idx_x)[keep])
    for ex in (excl, jnp.full((n,), -1, jnp.int32)):
        occ = np.asarray(sphere_kernel.any_hit(o, d, tmin, tmax, c, r, ex,
                                               interpret=True))
        occ_x = np.asarray(_xla_any(o, d, tmin, tmax, ex, c, r))
        np.testing.assert_array_equal(occ[keep], occ_x[keep])


def test_public_entry_points_keep_leading_shape():
    """intersect_spheres / intersect_spheres_any take (..., 3) rays and
    broadcastable ranges, and return the leading shape."""
    c, r = map(jnp.asarray, _scene())
    o, d, _, _, excl = _rays(35)
    o = jnp.asarray(o).reshape(5, 7, 3)
    d = jnp.asarray(d).reshape(5, 7, 3)
    hit = intersect.intersect_spheres(o, d, 0.0, jnp.inf, c, r,
                                      block_size=BLOCK)
    assert hit.t.shape == (5, 7) and hit.normal.shape == (5, 7, 3)
    t, idx = _xla_closest(o.reshape(-1, 3), d.reshape(-1, 3),
                          jnp.zeros(35), jnp.full(35, jnp.inf), c, r)
    np.testing.assert_array_equal(np.asarray(hit.index).reshape(-1),
                                  np.asarray(idx))
    occ = intersect.intersect_spheres_any(
        o, d, 0.0, jnp.full((5, 7), 10.0), c, r, BLOCK,
        exclude_index=jnp.asarray(excl).reshape(5, 7))
    assert occ.shape == (5, 7) and occ.dtype == jnp.bool_


@pytest.mark.gpu
def test_kernel_compiled_matches_xla(gpu):
    """The compiled Triton kernels on the card (chip_smoke.py runs the
    same comparison at 4.1M rays)."""
    c, r = map(jnp.asarray, _scene())
    o, d, tmin, tmax, excl = map(jnp.asarray, _rays(4096))
    t, idx = sphere_kernel.closest_hit(o, d, tmin, tmax, c, r)
    t_all, best, ref_idx, keep = _reference(*map(np.asarray,
                                                 (o, d, tmin, tmax, c, r)))
    _check_closest(t, idx, best, ref_idx, keep)
    occ = np.asarray(sphere_kernel.any_hit(o, d, tmin, tmax, c, r, excl))
    np.testing.assert_array_equal(
        occ[keep], _any_reference(t_all, np.asarray(excl))[keep])
