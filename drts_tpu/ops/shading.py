"""Material evaluation at hit points: texture application + normal mapping.

Reimplementation of ``EvaluateMaterial`` and friends
(/root/reference/Shaders/ShadingHelpers.hlsli:61-235). The reference's 6
independent per-material texture maps become ONE packed quad-duplicated
texture-set row per hit (models/texpack.py): a single 16-48 byte gather
replaces up to 24 narrow ones. A map index of -1 means "slot unused" and
multiplies by 1, keeping every lane's control flow uniform.
"""

from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from ..utils import math as m
from ..models.material import Materials
from ..models.texpack import PackedTextures


def sample_atlas(atlas, tex_index, uv, filter: str = "bilinear"):
    """Sample a raw float atlas (T, S, S, 4); identity where tex_index < 0.
    Retained for environment maps and as the texel-exact reference for the
    packed path's parity tests; hit shading uses `sample_packed`.
    (wrap in U, clamp in V — lat-long convention)."""
    t, s = atlas.shape[0], atlas.shape[1]
    idx = jnp.clip(tex_index, 0, t - 1)
    # Single-axis gathers from the flattened atlas rather than
    # multi-index-array advanced indexing.
    flat = atlas.reshape(-1, atlas.shape[-1])
    base = idx * (s * s)
    if filter == "nearest":
        xi = jnp.mod((uv[..., 0] * s).astype(jnp.int32), s)
        yi = jnp.clip((uv[..., 1] * s).astype(jnp.int32), 0, s - 1)
        value = flat[base + yi * s + xi]
        return jnp.where((tex_index >= 0)[..., None], value,
                         jnp.ones_like(value))
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = jnp.clip(y - jnp.clip(y0, 0, s - 1), 0.0, 1.0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), s)
    x1i = jnp.mod(x0i + 1, s)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, s - 1)
    y1i = jnp.clip(y0i + 1, 0, s - 1)
    c00 = flat[base + y0i * s + x0i]
    c10 = flat[base + y0i * s + x1i]
    c01 = flat[base + y1i * s + x0i]
    c11 = flat[base + y1i * s + x1i]
    value = m.lerp(m.lerp(c00, c10, fx), m.lerp(c01, c11, fx), fy)
    return jnp.where((tex_index >= 0)[..., None], value,
                     jnp.ones_like(value))


def _unpack4(word):
    """u32 -> 4 floats in [0, 1] (u8 channels, low byte first)."""
    w = word.astype(jnp.uint32)
    return [(((w >> s) & jnp.uint32(0xFF)).astype(jnp.float32)
             * (1.0 / 255.0)) for s in (0, 8, 16, 24)]


@struct.dataclass
class SampledSet:
    """Decoded texture-set sample (neutral 1 / flat normal where unused)."""
    base_rgb: jnp.ndarray      # (..., 3) sqrt-decoded
    alpha: jnp.ndarray         # (...,)
    normal_xy: jnp.ndarray     # (..., 2) in [-1, 1]
    metallic: jnp.ndarray      # (...,)
    roughness: jnp.ndarray     # (...,)
    emissive_rgb: jnp.ndarray  # (..., 3)
    transmission: jnp.ndarray  # (...,)


def sample_packed(tex: PackedTextures, set_index, uv,
                  filter: str = "bilinear") -> SampledSet:
    """ONE row gather -> full material texture sample (exact bilinear via
    the quad-duplicated footprint). set_index < 0 lanes decode to neutral."""
    s = tex.size
    w_n = tex.n_words
    idx = jnp.maximum(set_index, 0)
    # sqrt-coded channels (color) must be DECODED per tap before the
    # bilinear blend — lerping in sqrt space then squaring skews mid-lerp
    # values by up to ~0.18 (caught by the packed-vs-float parity test).
    sq = {(0, 0), (0, 1), (0, 2), (2, 0), (2, 1), (2, 2)}

    def decode(corner_words):
        out = []
        for w, word in enumerate(corner_words):
            ch = _unpack4(word)
            out.append([c * c if (w, i) in sq else c
                        for i, c in enumerate(ch)])
        return out

    if filter in ("nearest", "nearest0"):
        # "nearest" callers are deep-bounce / wide-footprint fetches
        # (pathtrace texture_bounces policy): read the half-res mip — the
        # area-filtered value their footprint wants, from a 4x smaller
        # table (texpack.PackedTextures.rows_half,
        # the MipmapGeneration.hlsl role). "nearest0" pins level 0 (the
        # alpha-test fetch at primary hits, ops/trace.py — cutout
        # silhouettes must not blur).
        use_half = filter == "nearest" and tex.rows_half is not None
        table = tex.rows_half if use_half else tex.rows
        s = tex.half_size if use_half else s
        xi = jnp.mod((uv[..., 0] * s).astype(jnp.int32), s)
        yi = jnp.clip((uv[..., 1] * s).astype(jnp.int32), 0, s - 1)
        rows = table[idx * (s * s) + yi * s + xi]          # (..., 4W)
        words = decode([rows[..., w] for w in range(w_n)])  # c00 only
    else:
        x = uv[..., 0] * s - 0.5
        y = uv[..., 1] * s - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = x - x0
        y0c = jnp.clip(y0, 0, s - 1)
        fy = jnp.clip(y - y0c, 0.0, 1.0)
        xi = jnp.mod(x0.astype(jnp.int32), s)
        yi = y0c.astype(jnp.int32)
        rows = tex.rows[idx * (s * s) + yi * s + xi]       # (..., 4W)
        w00 = (1 - fx) * (1 - fy)
        w10 = fx * (1 - fy)
        w01 = (1 - fx) * fy
        w11 = fx * fy
        corners = [decode([rows[..., c * w_n + w] for w in range(w_n)])
                   for c in range(4)]
        c00, c10, c01, c11 = corners
        words = [[c00[w][i] * w00 + c10[w][i] * w10
                  + c01[w][i] * w01 + c11[w][i] * w11 for i in range(4)]
                 for w in range(w_n)]

    used = set_index >= 0
    one = jnp.ones_like(words[0][0])

    def ch(v, neutral=1.0):
        return jnp.where(used, v, neutral)

    b0, b1, b2, alpha = words[0]
    base_rgb = jnp.stack([ch(b0), ch(b1), ch(b2)], axis=-1)
    nx, ny, metallic, roughness = words[1]
    normal_xy = jnp.stack([ch(nx, 0.5), ch(ny, 0.5)], axis=-1) * 2.0 - 1.0
    if w_n >= 3:
        e0, e1, e2, trans = words[2]
        emissive = jnp.stack([ch(e0), ch(e1), ch(e2)], axis=-1)
        trans = ch(trans)
    else:
        emissive = jnp.ones(base_rgb.shape, jnp.float32)
        trans = one
    return SampledSet(base_rgb=base_rgb, alpha=ch(alpha),
                      normal_xy=normal_xy, metallic=ch(metallic),
                      roughness=ch(roughness), emissive_rgb=emissive,
                      transmission=trans)


@struct.dataclass
class EvaluatedMaterial:
    """Post-texture material parameters at a hit."""
    base_color: jnp.ndarray      # (..., 3)
    alpha: jnp.ndarray           # (...,)
    emission: jnp.ndarray        # (..., 3)
    metallic: jnp.ndarray        # (...,)
    roughness: jnp.ndarray       # (...,)
    ior: jnp.ndarray             # (...,)
    transmission: jnp.ndarray    # (...,)
    shading_normal: jnp.ndarray  # (..., 3) possibly normal-mapped


def evaluate_material(mat: Materials, uv, shading_normal, tangent,
                      textures: PackedTextures | None = None,
                      filter: str = "bilinear") -> EvaluatedMaterial:
    """ShadingHelpers.hlsli:161-235 EvaluateMaterial, vectorized.

    `mat` holds per-ray gathered parameters (Materials.gather); its map
    columns carry the material's texture-SET id (models/texpack.py), so the
    whole texture evaluation is one packed-row gather. When `textures` is
    None all texture slots are treated as unused.
    """
    base_color = mat.base_color[..., :3]
    alpha = mat.base_color[..., 3]
    emission = mat.emission()
    metallic = mat.metallic
    roughness = mat.roughness
    transmission = mat.transmission
    n = shading_normal

    if textures is not None:
        # Any used slot holds the set id; unused slots are -1. Channels a
        # material does not map are baked neutral in its set, so one id
        # drives every channel with no per-channel gating.
        set_idx = jnp.maximum(
            jnp.maximum(jnp.maximum(mat.base_color_map, mat.normal_map),
                        jnp.maximum(mat.metallic_map, mat.roughness_map)),
            jnp.maximum(mat.emissive_color_map, mat.transmission_map))
        ts = sample_packed(textures, set_idx, uv, filter)
        base_color = base_color * ts.base_rgb
        alpha = alpha * ts.alpha
        emission = emission * ts.emissive_rgb
        metallic = metallic * ts.metallic
        roughness = roughness * ts.roughness
        transmission = transmission * ts.transmission
        # Normal perturbation (ShadingHelpers.hlsli:89-103): 2-channel
        # local normal, z reconstructed.
        nxy = ts.normal_xy
        nz = jnp.sqrt(jnp.maximum(
            1.0 - nxy[..., 0] ** 2 - nxy[..., 1] ** 2, 0.0))
        t, b, nn = m.calculate_tbn(n, tangent)
        perturbed = m.normalize(nxy[..., 0:1] * t + nxy[..., 1:2] * b
                                + nz[..., None] * nn)
        n = jnp.where((mat.normal_map >= 0)[..., None], perturbed, n)

    return EvaluatedMaterial(
        base_color=base_color, alpha=alpha, emission=emission,
        metallic=metallic, roughness=roughness, ior=mat.ior,
        transmission=jnp.where(metallic < 1.0, transmission, 0.0),
        shading_normal=n)
