"""Post-processing: bloom, merge, sharpening, tone mapping, mip generation.

Reimplementation of the reference's post chain
(/root/reference/Source/{Bloom,Merge,MipmapGeneration}.ixx +
/root/reference/Shaders/{Bloom,Merge,MipmapGeneration}.hlsl and the
DirectXTK12 ToneMapPostProcess operators used at App.cpp:1731-1757).
Each pass is a pure (H, W, 3) -> (H, W, 3) function; XLA fuses the
elementwise chains, and the separable/fixed-footprint filters compile to
dense vector code.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import math as m


# ----------------------------------------------------------------------------
# Tone mapping (ToneMapPostProcess: Saturate | Reinhard | ACESFilmic)


def tonemap_saturate(x, exposure=1.0):
    return m.saturate(x * exposure)


def tonemap_reinhard(x, exposure=1.0):
    x = jnp.maximum(x * exposure, 0.0)
    return x / (1.0 + x)


def tonemap_aces(x, exposure=1.0):
    """ACES filmic fit (Narkowicz) — the operator family DirectXTK's
    ToneMapPostProcess::Operator_ACESFilmic applies."""
    x = jnp.maximum(x * exposure, 0.0)
    return m.saturate((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14))


TONEMAP_OPERATORS = {
    "Saturate": tonemap_saturate,
    "Reinhard": tonemap_reinhard,
    "ACESFilmic": tonemap_aces,
}

# Color-primary rotations (ToneMapPostProcess::SetColorRotation,
# App.cpp:1744 + the 3-way Combo at App.cpp:2216-2225). Standard primaries
# conversion matrices (Rec.709 / DCI-P3-D65 / Rec.2020, D65 white).
REC709_TO_REC2020 = (
    (0.627404, 0.329283, 0.043313),
    (0.069097, 0.919540, 0.011362),
    (0.016392, 0.088013, 0.895595),
)
P3D65_TO_REC2020 = (
    (0.753833, 0.198597, 0.047570),
    (0.045744, 0.941777, 0.012479),
    (-0.001210, 0.017602, 0.983608),
)
REC709_TO_P3D65 = (
    (0.822462, 0.177538, 0.000000),
    (0.033194, 0.966806, 0.000000),
    (0.017083, 0.072397, 0.910520),
)
COLOR_ROTATIONS = {
    "HDTV_to_UHDTV": REC709_TO_REC2020,
    "DCI_P3_D65_to_UHDTV": P3D65_TO_REC2020,
    "HDTV_to_DCI_P3_D65": REC709_TO_P3D65,
}


def st2084_encode(nits):
    """SMPTE ST.2084 (PQ) OETF: absolute luminance in nits -> signal.
    The transfer DirectXTK's Operator_None+ST2084 path applies for HDR10
    swap chains (App.cpp:1737-1744)."""
    m1, m2 = 2610.0 / 16384.0, 2523.0 / 4096.0 * 128.0
    c1 = 3424.0 / 4096.0
    c2 = 2413.0 / 4096.0 * 32.0
    c3 = 2392.0 / 4096.0 * 32.0
    y = jnp.clip(nits / 10000.0, 0.0, 1.0)
    yp = jnp.power(y, m1)
    return jnp.power((c1 + c2 * yp) / (1.0 + c3 * yp), m2)


def tonemap_hdr10(x, exposure: float = 1.0, paper_white_nits: float = 200.0,
                  color_rotation: str = "HDTV_to_UHDTV"):
    """HDR output: scene-linear -> primaries rotation -> scale by
    paper-white nits -> ST.2084 encode (App.cpp:1737-1744: ST2084 operator +
    color rotation + PaperWhiteNits). `color_rotation` selects among the
    reference's three ColorPrimaryRotation variants."""
    v = jnp.maximum(x * exposure, 0.0)
    mat = jnp.asarray(COLOR_ROTATIONS[color_rotation], v.dtype)
    # HIGHEST: a default-precision f32 product may run in TF32 on the GPU.
    v = jnp.einsum("...c,rc->...r", v, mat,
                   precision=jax.lax.Precision.HIGHEST)
    return st2084_encode(v * paper_white_nits)


def tonemap(x, operator: str = "ACESFilmic", exposure: float = 1.0,
            output_srgb: bool = True, hdr: bool = False,
            paper_white_nits: float = 200.0,
            color_rotation: str = "HDTV_to_UHDTV"):
    """Display mapping. SDR: operator curve + sRGB encode. HDR
    (App.cpp:1737-1744): ST.2084/Rec.2020 signal (no sRGB, no SDR curve)."""
    if hdr:
        return tonemap_hdr10(x, exposure, paper_white_nits, color_rotation)
    y = TONEMAP_OPERATORS[operator](x, exposure)
    return m.to_srgb(y) if output_srgb else y


# ----------------------------------------------------------------------------
# Merge (Shaders/Merge.hlsl:24-35): out = in1*w1 + in2*w2 (in2 bilinear).


def merge(a, b, weight_a, weight_b):
    if b.shape[:2] != a.shape[:2]:
        b = resize_bilinear(b, a.shape[0], a.shape[1])
    return a * weight_a + b * weight_b


def resize_bilinear(img, out_h: int, out_w: int):
    """Bilinear resize (align-corners=False, clamp addressing) — the
    sampler behavior the post shaders rely on."""
    h, w = img.shape[0], img.shape[1]
    y = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) * (h / out_h) - 0.5
    x = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) * (w / out_w) - 0.5
    y0 = jnp.floor(y)
    x0 = jnp.floor(x)
    fy = (y - y0)[:, None, None]
    fx = (x - x0)[None, :, None]
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    c00 = img[y0i][:, x0i]
    c01 = img[y0i][:, x1i]
    c10 = img[y1i][:, x0i]
    c11 = img[y1i][:, x1i]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


# ----------------------------------------------------------------------------
# Bloom (Shaders/Bloom.hlsl:33-110): CoD-style 13-tap Karis-average
# downsample and 9-tap tent upsample over a 5-level pyramid, merged with a
# strength weight (Bloom.ixx:81-131, default 0.05).


def _shift(img, dy: int, dx: int):
    """Clamp-addressed neighborhood shift via edge-pad + static slice —
    a plain copy XLA fuses, where an index-vector gather would not be."""
    h, w = img.shape[0], img.shape[1]
    pads = ((max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0)))
    pads = pads + ((0, 0),) * (img.ndim - 2)
    p = jnp.pad(img, pads, mode="edge")
    return p[max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w]


def _karis_weight(c):
    return 1.0 / (1.0 + m.luminance(c)[..., None])


def bloom_downsample(img):
    """13-tap downsample with Karis average on the first group structure
    (firefly suppression), then 2x decimation."""
    # 5 overlapping 4-tap box groups (CoD Bloom): center group weighted 0.5,
    # corner groups 0.125 each.
    def box(dy, dx):
        return 0.25 * (_shift(img, dy, dx) + _shift(img, dy, dx + 1)
                       + _shift(img, dy + 1, dx) + _shift(img, dy + 1, dx + 1))

    g_c = box(0, 0)
    g_tl = box(-1, -1)
    g_tr = box(-1, 1)
    g_bl = box(1, -1)
    g_br = box(1, 1)
    w_c = _karis_weight(g_c) * 0.5
    w_tl = _karis_weight(g_tl) * 0.125
    w_tr = _karis_weight(g_tr) * 0.125
    w_bl = _karis_weight(g_bl) * 0.125
    w_br = _karis_weight(g_br) * 0.125
    total = w_c + w_tl + w_tr + w_bl + w_br
    filtered = (g_c * w_c + g_tl * w_tl + g_tr * w_tr + g_bl * w_bl
                + g_br * w_br) / total
    return filtered[::2, ::2]


def bloom_upsample(img, out_h: int, out_w: int):
    """9-tap tent filter upsample (Bloom.hlsl upsample pass)."""
    up = resize_bilinear(img, out_h, out_w)
    acc = 4.0 * up
    for dy, dx, w in ((-1, 0, 2.0), (1, 0, 2.0), (0, -1, 2.0), (0, 1, 2.0),
                      (-1, -1, 1.0), (-1, 1, 1.0), (1, -1, 1.0), (1, 1, 1.0)):
        acc = acc + w * _shift(up, dy, dx)
    return acc / 16.0


def bloom(img, strength: float = 0.05, levels: int = 4):
    """Full bloom chain (Bloom.ixx::Process): 4 downsamples, 4 tent
    upsamples with additive blend, final merge at `strength`."""
    mips = [img]
    for _ in range(levels):
        mips.append(bloom_downsample(mips[-1]))
    up = mips[-1]
    for level in range(levels - 1, -1, -1):
        target = mips[level]
        up = target + bloom_upsample(up, target.shape[0], target.shape[1])
    return merge(img, up / (levels + 1), 1.0 - strength, strength)


# ----------------------------------------------------------------------------
# Sharpen (NIS stand-in, App.cpp:1498-1502): contrast-adaptive unsharp mask.


def sharpen(img, sharpness: float = 0.5):
    blur = 0.25 * (_shift(img, -1, 0) + _shift(img, 1, 0)
                   + _shift(img, 0, -1) + _shift(img, 0, 1))
    amount = 0.8 * sharpness
    return jnp.maximum(img + (img - blur) * amount, 0.0)


# ----------------------------------------------------------------------------
# Chromatic aberration (reference README.md "Post-Processing > Chromatic
# Aberration"; the code snapshot at /root/reference ships no shader for it,
# so this implements the standard lateral-CA model: each channel magnified
# about the image center by a slightly different factor — R outward, B
# inward). A center scale is separable, so with a STATIC strength the whole
# effect lowers to four monotone static-index gathers per channel (no 2-D
# warp gather).


def _scale_about_center(ch, scale: float):
    """Bilinear resample of (H, W) channel `ch` magnified by `scale` about
    the center. `scale` is a static python float."""
    out = ch
    for axis in (0, 1):
        n = out.shape[axis]
        coords = (np.arange(n, dtype=np.float64) - (n - 1) / 2) / scale \
            + (n - 1) / 2
        i0 = np.clip(np.floor(coords).astype(np.int32), 0, n - 1)
        i1 = np.minimum(i0 + 1, n - 1)
        f = jnp.asarray(np.clip(coords - i0, 0.0, 1.0), jnp.float32)
        a = jnp.take(out, jnp.asarray(i0), axis=axis)
        b = jnp.take(out, jnp.asarray(i1), axis=axis)
        fshape = [1, 1]
        fshape[axis] = n
        out = a + (b - a) * f.reshape(fshape)
    return out


def chromatic_aberration(img, strength: float = 0.0):
    """(H, W, 3) display-space image -> lateral CA. strength ~ the relative
    magnification split between R and B at the image corner (0 = off,
    typical 0.002-0.01)."""
    if strength <= 0.0:
        return img
    scales = (1.0 + strength, 1.0, 1.0 - strength)
    return jnp.stack([img[..., c] if s == 1.0
                      else _scale_about_center(img[..., c], s)
                      for c, s in enumerate(scales)], axis=-1)


# ----------------------------------------------------------------------------
# Mip pyramid (MipmapGeneration.hlsl wave-op 5-mip averager) — used for the
# ReSTIR light-PDF texture, as a plain reshape-mean reduction.


def generate_mips(img, levels: int):
    """Returns [img, mip1, ..., mipN] with 2x2 averaging per level.
    img: (H, W) or (H, W, C) with H, W divisible by 2^levels."""
    mips = [img]
    cur = img
    for _ in range(levels):
        h, w = cur.shape[0] // 2, cur.shape[1] // 2
        if cur.ndim == 2:
            cur = cur.reshape(h, 2, w, 2).mean(axis=(1, 3))
        else:
            cur = cur.reshape(h, 2, w, 2, cur.shape[-1]).mean(axis=(1, 3))
        mips.append(cur)
    return mips
