"""Packed per-material texture sets: one gather per hit.

The reference samples up to 6 independent texture maps per hit with
hardware bilinear units (/root/reference/Shaders/ShadingHelpers.hlsli:161-235
EvaluateMaterial; maps bound per material, Source/Material.ixx:12-38).
Without texture units every map and every bilinear tap is a separate
gather, and cost scales with gather count and row bytes.

So all maps a material uses are baked at load time into ONE texel row of
u8 channels, and each texel row carries its entire 2x2 bilinear footprint
("quad duplication"), so EvaluateMaterial needs exactly ONE 16-48 byte
gather per hit. 4x memory for quad rows is cheap (a 256^2 2-word set =
2 MB) and keeps the table small.

Texel word layout (u8x4 per u32 word, quad order c00 c10 c01 c11,
word-interleaved per corner):
  word 0: base color R, G, B, A       (sqrt-encoded color, linear alpha)
  word 1: normal X, normal Y, metallic, roughness
  word 2 (only when some material uses emissive/transmission maps):
          emissive R, G, B (sqrt-encoded), transmission

Materials keep their TextureMapType slot columns, but after `build` each
used slot holds the material's SET id (unused stay -1), so shading reads
one id with no schema change; unused channels bake to neutral (white /
flat normal), so no per-channel gating is needed at sample time.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
from ..utils import struct

from .material import Materials


@struct.dataclass
class PackedTextures:
    """Quad-duplicated packed texture sets (device-resident)."""
    rows: jnp.ndarray           # (T'*S*S, 4*W) uint32
    emissive_mean: jnp.ndarray  # (T', 3) per-set emissive-map mean (1 = none)
    size: int = struct.field(pytree_node=False)
    n_words: int = struct.field(pytree_node=False)
    # Half-resolution mip (the MipmapGeneration.hlsl role): deep-bounce
    # fetches are nearest anyway (their ray footprint exceeds texel size —
    # ops/pathtrace texture_bounces), so they read this 4x-smaller table
    # instead — the area-filtered value their footprint wants AND a
    # smaller gather source.
    rows_half: jnp.ndarray | None = None    # (T'*(S/2)^2, 4*W) uint32
    half_size: int = struct.field(pytree_node=False, default=0)
    # Small f32 emissive mips for light preparation's per-TRIANGLE filtered
    # emission (LightPreparation.hlsl:86-128 SampleGrad over the triangle's
    # UV footprint): ops/light._face_emissive_avg rasterizes each emissive
    # face's UV triangle over this grid. None when no set has an emissive
    # map (the per-set whole-map mean then remains the fallback).
    emissive_small: jnp.ndarray | None = None   # (T', 32, 32, 3) float32


_MAP_FIELDS = ("base_color_map", "normal_map", "metallic_map",
               "roughness_map", "emissive_color_map", "transmission_map")


def _u8(x):
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint32)


def _pack_word(c0, c1, c2, c3):
    return _u8(c0) | (_u8(c1) << 8) | (_u8(c2) << 16) | (_u8(c3) << 24)


def _resize_area(img: np.ndarray, size: int) -> np.ndarray:
    """Area-average downsample (or nearest upsample) to (size, size, C)."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img
    if h % size == 0 and w % size == 0:
        fy, fx = h // size, w // size
        return img.reshape(size, fy, size, fx, -1).mean(axis=(1, 3))
    yi = (np.arange(size) * (h / size)).astype(np.int64)
    xi = (np.arange(size) * (w / size)).astype(np.int64)
    return img[yi][:, xi]


def _quad(img: np.ndarray) -> np.ndarray:
    """(S, S, C) -> (S, S, 4, C): the 2x2 bilinear footprint of each texel,
    U wrapping, V clamping (the lat-long convention of ops/shading.py)."""
    xp = np.concatenate([img[:, 1:], img[:, :1]], axis=1)
    yc = np.concatenate([img[1:], img[-1:]], axis=0)
    ycxp = np.concatenate([yc[:, 1:], yc[:, :1]], axis=1)
    return np.stack([img, xp, yc, ycxp], axis=2)


def build(atlas: np.ndarray | None, materials: Materials, size: int = 256
          ) -> tuple[PackedTextures | None, Materials]:
    """Bake per-material texture sets from the (T, S0, S0, 4) float atlas.

    Returns (packed, materials') where materials' has every used map slot
    rewritten to the material's set id. atlas=None -> (None, materials).
    """
    if atlas is None:
        return None, materials
    atlas = np.asarray(atlas, np.float32)
    t = atlas.shape[0]

    cols = {f: np.asarray(getattr(materials, f)) for f in _MAP_FIELDS}
    k = cols["base_color_map"].shape[0]

    # Unique map combos -> set ids.
    combos: dict[tuple, int] = {}
    set_of = np.full((k,), -1, np.int64)
    for i in range(k):
        combo = tuple(int(cols[f][i]) for f in _MAP_FIELDS)
        if all(c < 0 for c in combo):
            continue
        if combo not in combos:
            combos[combo] = len(combos)
        set_of[i] = combos[combo]
    if not combos:
        return None, materials

    needs_w2 = any(c[4] >= 0 or c[5] >= 0 for c in combos)
    n_words = 3 if needs_w2 else 2

    def bake_rows(sz):
        def slot(idx, neutral):
            if idx < 0 or idx >= t:
                return np.broadcast_to(np.asarray(neutral, np.float32),
                                       (sz, sz, len(neutral))).copy()
            return _resize_area(atlas[idx], sz)

        rows_all = []
        for combo in combos:
            bcm, nm, mm, rm, em, tm = combo
            base = slot(bcm, (1.0, 1.0, 1.0, 1.0))
            normal = slot(nm, (0.5, 0.5, 1.0, 1.0))
            metallic = slot(mm, (1.0,))[..., 0]
            rough = slot(rm, (1.0,))[..., 0]
            w0 = _pack_word(np.sqrt(np.clip(base[..., 0], 0, 1)),
                            np.sqrt(np.clip(base[..., 1], 0, 1)),
                            np.sqrt(np.clip(base[..., 2], 0, 1)),
                            base[..., 3])
            w1 = _pack_word(normal[..., 0], normal[..., 1], metallic, rough)
            words = [w0, w1]
            if needs_w2:
                emis = slot(em, (1.0, 1.0, 1.0, 1.0))
                trans = slot(tm, (1.0,))[..., 0]
                words.append(
                    _pack_word(np.sqrt(np.clip(emis[..., 0], 0, 1)),
                               np.sqrt(np.clip(emis[..., 1], 0, 1)),
                               np.sqrt(np.clip(emis[..., 2], 0, 1)),
                               trans))
            texel = np.stack(words, axis=-1)             # (S, S, W)
            quad = _quad(texel)                          # (S, S, 4, W)
            rows_all.append(quad.reshape(sz * sz, 4 * n_words))
        return np.concatenate(rows_all, axis=0)

    emissive_mean = [atlas[c[4]][..., :3].mean(axis=(0, 1))
                     if c[4] >= 0 else np.ones(3, np.float32)
                     for c in combos]
    emissive_small = None
    if any(c[4] >= 0 for c in combos):
        sz = 32
        emissive_small = jnp.asarray(np.stack(
            [_resize_area(atlas[c[4]][..., :3], sz) if c[4] >= 0
             else np.ones((sz, sz, 3), np.float32) for c in combos]
        ).astype(np.float32))

    half = size // 2 if size >= 8 else 0
    packed = PackedTextures(
        rows=jnp.asarray(bake_rows(size)),
        emissive_mean=jnp.asarray(np.stack(emissive_mean)),
        size=size, n_words=n_words,
        rows_half=jnp.asarray(bake_rows(half)) if half else None,
        half_size=half,
        emissive_small=emissive_small)

    new_cols = {}
    for f in _MAP_FIELDS:
        c = cols[f].astype(np.int32)
        new_cols[f] = jnp.asarray(np.where(c >= 0, set_of, -1)
                                  .astype(np.int32))
    return packed, dataclasses.replace(materials, **new_cols)
