"""Asset loading: texture atlas construction from image files.

Replacement for DirectXTex loading + the threaded
ResourceDictionary (/root/reference/Source/TextureHelpers.ixx:34-138,
ResourceHelpers.ixx:36-114): images decode host-side (PIL, gated), resize
to one atlas resolution, sRGB-decode color maps, and stack into a single
(T, S, S, 4) float32 array — one device upload, shared by every shading
kernel via per-object map indices (see ops/shading.py).
"""

from __future__ import annotations

import os

import numpy as np

from .. import CHECKOUT
from ..utils import image as image_mod

# Reference asset set (MyScene.ixx:161-165, 286-294).
TEXTURE_FILES = [
    ("Alien-Metal_Albedo.png", True),      # 0: sRGB base color
    ("Alien-Metal_Metallic.png", False),   # 1
    ("Alien-Metal_Roughness.png", False),  # 2
    ("Alien-Metal_Normal.png", False),     # 3
    ("Moon_BaseColor.jpg", True),          # 4
    ("Moon_Normal.jpg", False),            # 5
    ("Earth_BaseColor.jpg", True),         # 6
    ("Earth_Normal.jpg", False),           # 7
]

ALIEN_BASE, ALIEN_METALLIC, ALIEN_ROUGH, ALIEN_NORMAL = 0, 1, 2, 3
MOON_BASE, MOON_NORMAL, EARTH_BASE, EARTH_NORMAL = 4, 5, 6, 7

# The reference's texture files, when a checkout carries them (they are
# not part of this repository yet; without them materials fall back to
# their constant colors and the run reports textures_loaded = False).
DEFAULT_ASSET_DIR = os.path.join(CHECKOUT, "assets", "textures")


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def load_texture_atlas(asset_dir: str = DEFAULT_ASSET_DIR,
                       size: int = 512):
    """Build the (T, S, S, 4) atlas with PER-FILE fallback.

    Returns ``(atlas, present)`` where ``present[i]`` says whether slot i
    actually loaded; a missing or undecodable file fills its slot with
    neutral white and materials reference it as -1 (constant fallback) —
    mirroring the reference, where one missing texture map degrades that
    map only, not all texturing (Source/MyScene.ixx:161-165). Returns
    ``(None, [False]*T)`` when nothing loads (no PIL / no asset dir).

    Note: ``Alien-Metal_Normal.png`` genuinely does not exist in the
    reference asset snapshot (7 files under Assets/Textures); round 2's
    all-or-nothing load therefore never produced an atlas at all.
    """
    textures: list = []
    present: list = []
    neutral = np.ones((size, size, 4), np.float32)
    for name, is_srgb in TEXTURE_FILES:
        path = os.path.join(asset_dir, name)
        img = image_mod.load_image(path, size=size) \
            if os.path.exists(path) else None
        if img is None:
            textures.append(neutral)
            present.append(False)
            continue
        if is_srgb:
            img = np.concatenate([_srgb_to_linear(img[..., :3]),
                                  img[..., 3:4]], axis=-1)
        textures.append(img)
        present.append(True)
    if not any(present):
        return None, present
    return np.stack(textures).astype(np.float32), present
