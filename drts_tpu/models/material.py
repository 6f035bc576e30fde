"""PBR material parameters, structure-of-arrays.

Reimplementation of the reference's Source/Material.ixx (POD
Material + texture-map slots): identical fields and defaults, but stored as
one array per field over all objects — the layout every shading kernel wants
on a vector machine.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
from ..utils import struct


@dataclasses.dataclass
class MaterialDesc:
    """Host-side material description (Material.ixx defaults)."""
    base_color: tuple = (0.0, 0.0, 0.0, 1.0)
    emissive_strength: float = 1.0
    emissive_color: tuple = (0.0, 0.0, 0.0)
    metallic: float = 0.0
    roughness: float = 0.5
    ior: float = 1.5
    transmission: float = 0.0
    alpha_cutoff: float = 0.5
    # texture-map slots (TextureMapType); -1 = none. Index into the scene's
    # texture atlas (TextureHelpers analogue).
    base_color_map: int = -1
    emissive_color_map: int = -1
    metallic_map: int = -1
    roughness_map: int = -1
    normal_map: int = -1
    transmission_map: int = -1


@struct.dataclass
class Materials:
    """Device-side SoA over K objects."""
    base_color: jnp.ndarray        # (K, 4)
    emissive_strength: jnp.ndarray  # (K,)
    emissive_color: jnp.ndarray    # (K, 3)
    metallic: jnp.ndarray          # (K,)
    roughness: jnp.ndarray         # (K,)
    ior: jnp.ndarray               # (K,)
    transmission: jnp.ndarray      # (K,)
    alpha_cutoff: jnp.ndarray      # (K,)
    base_color_map: jnp.ndarray    # (K,) int32
    emissive_color_map: jnp.ndarray  # (K,) int32
    metallic_map: jnp.ndarray      # (K,) int32
    roughness_map: jnp.ndarray     # (K,) int32
    normal_map: jnp.ndarray        # (K,) int32
    transmission_map: jnp.ndarray  # (K,) int32

    def emission(self):
        """Material::GetEmission = strength * color."""
        return self.emissive_strength[..., None] * self.emissive_color

    def gather(self, idx):
        """Per-ray material fetch by object index."""
        return Materials(**{f.name: getattr(self, f.name)[idx]
                            for f in dataclasses.fields(Materials)})


def pack_materials(descs: list[MaterialDesc]) -> Materials:
    def arr(fn, dtype=np.float32):
        return jnp.asarray(np.array([fn(d) for d in descs], dtype=dtype))
    return Materials(
        base_color=arr(lambda d: d.base_color),
        emissive_strength=arr(lambda d: d.emissive_strength),
        emissive_color=arr(lambda d: d.emissive_color),
        metallic=arr(lambda d: d.metallic),
        roughness=arr(lambda d: d.roughness),
        ior=arr(lambda d: d.ior),
        transmission=arr(lambda d: d.transmission),
        alpha_cutoff=arr(lambda d: d.alpha_cutoff),
        base_color_map=arr(lambda d: d.base_color_map, np.int32),
        emissive_color_map=arr(lambda d: d.emissive_color_map, np.int32),
        metallic_map=arr(lambda d: d.metallic_map, np.int32),
        roughness_map=arr(lambda d: d.roughness_map, np.int32),
        normal_map=arr(lambda d: d.normal_map, np.int32),
        transmission_map=arr(lambda d: d.transmission_map, np.int32),
    )
