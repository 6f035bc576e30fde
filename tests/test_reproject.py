"""History reprojection gathers (ops/reproject.py) against numpy.

Zero, global (sub-pixel, off-frame at the edges) and discontinuous
(a moving object's edge) motion fields. Nearest copies packed f16-pair
rows bit for bit; bilinear matches a float64 interpolation at the same
float32 source positions; the in-bounds flag is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from drts_tpu.ops import reproject
from drts_tpu.utils import math as m

H, W = 24, 40


def _motion(kind):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    if kind == "zero":
        return np.zeros((H, W, 2), np.float32)
    if kind == "global":
        return np.broadcast_to(np.float32([2.37, -1.61]), (H, W, 2)).copy()
    mot = np.stack([0.8 * np.sin(yy / 5.0), 0.6 * np.cos(xx / 7.0)], -1)
    mot[:, W // 2:] += np.float32([-6.25, 3.5])     # object edge
    return mot.astype(np.float32)


def _positions(motion):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return (yy + motion[..., 1]).astype(np.float64), \
        (xx + motion[..., 0]).astype(np.float64)


def _in_bounds(py, px):
    return (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)


@pytest.mark.parametrize("kind", ["zero", "global", "discontinuous"])
def test_nearest_copies_packed_rows_bit_exact(kind):
    rng = np.random.RandomState(3)
    vals = rng.randn(H, W, 4).astype(np.float32) * 10
    packed = jnp.stack([m.pack2f16(vals[..., 0], vals[..., 1]),
                        m.pack2f16(vals[..., 2], vals[..., 3])], axis=-1)
    motion = _motion(kind)
    prev, inb = reproject.reproject(packed, jnp.asarray(motion), "nearest")
    py, px = _positions(motion)
    yi = np.clip(np.round(py), 0, H - 1).astype(int)
    xi = np.clip(np.round(px), 0, W - 1).astype(int)
    want = np.asarray(packed)[yi, xi]
    np.testing.assert_array_equal(np.asarray(prev).view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(inb), _in_bounds(py, px))
    if kind == "zero":
        np.testing.assert_array_equal(np.asarray(prev).view(np.uint32),
                                      np.asarray(packed).view(np.uint32))


@pytest.mark.parametrize("kind", ["zero", "global", "discontinuous"])
def test_bilinear_matches_float64(kind):
    rng = np.random.RandomState(4)
    src = rng.randn(H, W, 3).astype(np.float32)
    motion = _motion(kind)
    prev, inb = reproject.reproject(jnp.asarray(src), jnp.asarray(motion),
                                    "bilinear")
    py, px = _positions(motion)
    s = src.astype(np.float64)
    y0, x0 = np.floor(py), np.floor(px)
    fy, fx = (py - y0)[..., None], (px - x0)[..., None]
    y0i = np.clip(y0, 0, H - 1).astype(int)
    x0i = np.clip(x0, 0, W - 1).astype(int)
    y1i, x1i = np.minimum(y0i + 1, H - 1), np.minimum(x0i + 1, W - 1)
    want = ((s[y0i, x0i] * (1 - fx) + s[y0i, x1i] * fx) * (1 - fy)
            + (s[y1i, x0i] * (1 - fx) + s[y1i, x1i] * fx) * fy)
    np.testing.assert_allclose(np.asarray(prev), want, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(inb), _in_bounds(py, px))


def test_unknown_filter_raises():
    with pytest.raises(ValueError):
        reproject.reproject(jnp.zeros((4, 4, 1)), jnp.zeros((4, 4, 2)),
                            "catmull")
