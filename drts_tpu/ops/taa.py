"""Temporal anti-aliasing upscaler — the DLSS / XeSS super-resolution
stand-in.

Stands in for the Streamline/XeSS vendor integrations
(SURVEY.md §2.3: /root/reference/Source/Streamline.ixx, Source/XeSS.ixx,
wired at App.cpp:1644-1708): jittered low-res rendering accumulated into a
full-res history with motion-vector reprojection, Catmull-Rom history
resampling, and neighborhood variance clipping — the classical TAA-upscale
core those libraries refine. Same contract: render size < output size,
quality-mode scale factors match the reference's table
(App.cpp SetSuperResolutionOptions:1374-1451).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from ..utils import struct

from ..utils import math as m
from . import post
from .reproject import reproject

# DLSS/XeSS-style quality-mode render-scale table.
SCALE_FACTORS = {
    "Native": 1.0,
    "Quality": 1.5,
    "Balanced": 1.72,
    "Performance": 2.0,
    "UltraPerformance": 3.0,
    "Auto": 2.0,
}


def render_size_for(output_w: int, output_h: int, mode: str):
    s = SCALE_FACTORS[mode]
    return max(16, int(round(output_w / s))), max(16, int(round(output_h / s)))


@dataclasses.dataclass(frozen=True)
class TAAConfig:
    blend_alpha: float = 0.1
    clip_gamma: float = 1.0      # variance-clip box size in std-devs
    # Motion-adaptive clip: gamma blends toward this value as per-pixel
    # motion reaches ~1 output pixel/frame. A globally tight clip helps
    # under motion but costs static convergence; the adaptive form
    # applies each where it wins. < 0 disables (gamma stays clip_gamma
    # everywhere).
    clip_gamma_motion: float = -1.0
    # Motion magnitude (output px/frame) at which the adaptive gamma
    # saturates to clip_gamma_motion.
    clip_motion_px: float = 1.0
    # History resample: "catmull" = 16 row reads per pixel (sharpest),
    # "bilinear" = 4.
    history_filter: str = "bilinear"
    # Jitter-aware sample accumulation (the DLSS-style reconstruction):
    # the current frame is resampled at its TRUE sub-pixel sample positions
    # (grid shifted by the camera jitter) and each output pixel's blend
    # weight scales with its distance to the nearest real sample, so the
    # Halton jitter sequence adds sub-pixel detail instead of shimmer.
    jitter_aware: bool = True
    jitter_sigma: float = 0.45   # reconstruction kernel width (render px)


@struct.dataclass
class TAAState:
    history: jnp.ndarray         # (OH, OW, 3) output-res accumulated color


def init_state(out_height: int, out_width: int) -> TAAState:
    zero = jnp.zeros((out_height, out_width, 3), jnp.float32)
    return TAAState(history=zero)


def _catmull_rom_sample(img, y, x):
    """9-tap bicubic Catmull-Rom history resample (the filter DLSS-class
    TAA uses to avoid history blur)."""
    h, w = img.shape[0], img.shape[1]
    # Index convention: callers pass pixel-INDEX coordinates (centers at
    # integers, py + motion), so the integer base is floor(y) and f = 0 at
    # exact pixels — the filter must be the identity there. (The previous
    # half-texel-center form blurred even static history: identity error
    # 0.67, measured.)
    yc = jnp.floor(y)
    xc = jnp.floor(x)
    fy = y - yc
    fx = x - xc

    def weights(f):
        f2 = f * f
        f3 = f2 * f
        w0 = -0.5 * f3 + f2 - 0.5 * f
        w1 = 1.5 * f3 - 2.5 * f2 + 1.0
        w2 = -1.5 * f3 + 2.0 * f2 + 0.5 * f
        w3 = 0.5 * f3 - 0.5 * f2
        return w0, w1, w2, w3

    wy = weights(fy)
    wx = weights(fx)
    flat = img.reshape(-1, img.shape[-1])  # single-axis gathers (faster)
    acc = jnp.zeros(y.shape + (img.shape[-1],), img.dtype)
    for iy in range(4):
        yi = jnp.clip((yc + iy - 1).astype(jnp.int32), 0, h - 1)
        row = jnp.zeros_like(acc)
        for ix in range(4):
            xi = jnp.clip((xc + ix - 1).astype(jnp.int32), 0, w - 1)
            row = row + flat[yi * w + xi] * wx[ix][..., None]
        acc = acc + row * wy[iy][..., None]
    return jnp.maximum(acc, 0.0)


def _separable_bilinear(img, y, x):
    """Bilinear resample on a SEPARABLE coordinate grid (per-axis 1-D
    coords): two single-axis takes — contiguous row reads XLA handles
    cheaply — instead of 4 flat 2-D gathers. Valid
    whenever the sample positions are an axis-aligned affine map of the
    output grid (uniform scale + global jitter shift), which is exactly
    the current-frame resample's case."""
    h, w = img.shape[0], img.shape[1]
    y0 = jnp.floor(y)
    fy = (y - y0)[:, None, None]
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    rows = img[y0i] * (1.0 - fy) + img[y1i] * fy
    x0 = jnp.floor(x)
    fx = (x - x0)[None, :, None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    return rows[:, x0i] * (1.0 - fx) + rows[:, x1i] * fx


def upscale(state: TAAState, color, motion, jitter, out_h: int, out_w: int,
            reset, cfg: TAAConfig = TAAConfig(), confidence=None):
    """One TAA-upscale step.

    color: (RH, RW, 3) jittered render-res frame; motion: (RH, RW, 2)
    render-res pixel motion (prev = cur + motion); jitter: (2,) the pixel
    jitter (x, y) in render-pixel fractions (Math::CalculateUV convention);
    reset: scalar bool. ``confidence`` (RH, RW) in [0, 1], optional: the
    joint denoise+upscale coupling (DLSS-RR analogue, App.cpp:1654-1671) —
    low confidence (young denoiser history / disocclusion) raises the blend
    toward the current frame so the upscaler doesn't ghost stale shading.
    Returns (new_state, output (OH, OW, 3)).
    """
    rh, rw = color.shape[0], color.shape[1]
    scale_y = out_h / rh
    scale_x = out_w / rw

    if cfg.jitter_aware:
        # Resample the jittered sample grid at output-pixel centers: render
        # sample i sits at index i + jitter, so interpolating that grid at
        # render-space position q reads the source at q - jitter.
        qy = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) / scale_y - 0.5
        qx = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) / scale_x - 0.5
        sy = qy - jitter[1]                    # (OH,)
        sx = qx - jitter[0]                    # (OW,)
        up = _separable_bilinear(color, sy, sx)
        # Distance from each output pixel to the nearest true sample, per
        # axis, in render pixels -> reconstruction confidence.
        dy = sy - jnp.round(sy)
        dx = sx - jnp.round(sx)
        d2 = (dy * dy)[:, None] + (dx * dx)[None, :]
        sample_w = jnp.exp(-d2 / (2.0 * cfg.jitter_sigma ** 2))
    else:
        # Jitter-blind upsample (the pre-reconstruction fallback).
        up = post.resize_bilinear(color, out_h, out_w)
        sample_w = jnp.ones((out_h, out_w), jnp.float32)

    # Motion at output res, in output pixels.
    motion_up = post.resize_bilinear(motion, out_h, out_w) \
        * jnp.array([scale_x, scale_y])
    py = jnp.arange(out_h, dtype=jnp.float32)[:, None] \
        * jnp.ones((1, out_w), jnp.float32)
    px = jnp.arange(out_w, dtype=jnp.float32)[None, :] \
        * jnp.ones((out_h, 1), jnp.float32)
    if cfg.history_filter == "catmull":
        hist = _catmull_rom_sample(state.history, py + motion_up[..., 1],
                                   px + motion_up[..., 0])
    else:
        hist, _ = reproject(state.history, motion_up, cfg.history_filter)

    # Neighborhood variance clipping in the current frame (render res
    # neighborhood, evaluated at output res via the upsampled image).
    m1 = jnp.zeros_like(up)
    m2 = jnp.zeros_like(up)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ys = jnp.clip(jnp.arange(out_h) + dy, 0, out_h - 1)
            xs = jnp.clip(jnp.arange(out_w) + dx, 0, out_w - 1)
            s = up[ys][:, xs]
            m1 = m1 + s
            m2 = m2 + s * s
    mean = m1 / 9.0
    var = jnp.maximum(m2 / 9.0 - mean * mean, 0.0)
    gamma = jnp.float32(cfg.clip_gamma)
    if cfg.clip_gamma_motion >= 0.0:
        # Tighten the clip only where the pixel actually moves (saturating
        # at one output pixel/frame); static regions keep the loose box
        # that lets history converge past the 1spp noise floor.
        mlen = jnp.sqrt(motion_up[..., 0] ** 2 + motion_up[..., 1] ** 2)
        f = jnp.clip(mlen / cfg.clip_motion_px, 0.0, 1.0)[..., None]
        gamma = cfg.clip_gamma + (cfg.clip_gamma_motion - cfg.clip_gamma) * f
    sigma = jnp.sqrt(var) * gamma
    hist_clipped = jnp.clip(hist, mean - sigma, mean + sigma)

    in_bounds = (((py + motion_up[..., 1]) >= 0)
                 & ((py + motion_up[..., 1]) <= out_h - 1)
                 & ((px + motion_up[..., 0]) >= 0)
                 & ((px + motion_up[..., 0]) <= out_w - 1))
    alpha = cfg.blend_alpha * (0.25 + 0.75 * sample_w)
    if confidence is not None:
        conf_up = post.resize_bilinear(confidence[..., None], out_h,
                                       out_w)[..., 0]
        alpha = jnp.clip(alpha * (1.0 + 3.0 * (1.0 - conf_up)), 0.0, 1.0)
    alpha = jnp.where(in_bounds & ~reset, alpha, 1.0)[..., None]
    out = m.lerp(hist_clipped, up, alpha)
    return TAAState(history=out), out
