"""Per-triangle filtered emissive-texture averages in light preparation.

Reference behavior (LightPreparation.hlsl:86-128): each emissive
triangle's LightInfo radiance is the material emission scaled by a
filtered (SampleGrad, triangle-covering footprint) average of its
emissive map. Our array form (`light._face_emissive_avg`) computes
the exact UV-area average of the 32^2 emissive mip over each face's UV
triangle — these tests pin its correctness with maps whose regional
values make the expected average exact, plus a wrap-invariance check.
"""

import numpy as np
import jax.numpy as jnp

from drts_tpu.models import scene as scene_mod, texpack
from drts_tpu.models.material import MaterialDesc, pack_materials
from drts_tpu.ops import light as light_mod, sky, trimesh
from drts_tpu.utils import math as m

STRENGTH = 2.0


def _scene_with_uv_mesh(uvs_per_tri, atlas_emissive):
    """One non-emissive floor sphere + one mesh instance whose material has
    an emissive map. Each entry of uvs_per_tri is a (3, 2) UV triangle;
    vertices are duplicated per face so UV ranges stay independent."""
    n_tri = len(uvs_per_tri)
    pos, nrm, uv, tan, faces = [], [], [], [], []
    for i, tri_uv in enumerate(uvs_per_tri):
        base = 3 * i
        # Geometry is irrelevant to light prep power ratios: unit-area
        # right triangles stacked in y so areas match exactly.
        pos += [[0, i, 0], [2, i, 0], [0, i, 1]]
        nrm += [[0, 0, 1]] * 3
        uv += list(np.asarray(tri_uv, np.float32))
        tan += [[1, 0, 0]] * 3
        faces.append([base, base + 1, base + 2])
    mesh = trimesh.make_mesh(np.array(pos, np.float32),
                             np.array(nrm, np.float32),
                             np.array(uv, np.float32),
                             np.array(faces, np.int32),
                             tangents=np.array(tan, np.float32))
    mi = scene_mod.MeshInstances(
        center=jnp.zeros((1, 3)),
        rotation=jnp.tile(m.QUAT_IDENTITY, (1, 1)),
        prev_center=jnp.zeros((1, 3)),
        prev_rotation=jnp.tile(m.QUAT_IDENTITY, (1, 1)),
        scale=jnp.ones((1,)))
    atlas = np.zeros((1, 32, 32, 4), np.float32)
    atlas[0, :, :, :3] = atlas_emissive[..., None] if atlas_emissive.ndim == 2 \
        else atlas_emissive
    mats = pack_materials([
        MaterialDesc(base_color=(0.5, 0.5, 0.5, 1), roughness=0.6),
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=STRENGTH,
                     emissive_color=(1.0, 1.0, 1.0), emissive_color_map=0),
    ])
    packed, mats = texpack.build(atlas, mats, size=32)
    assert packed.emissive_small is not None
    assert packed.emissive_small.shape == (packed.emissive_mean.shape[0],
                                           32, 32, 3)
    center = jnp.array([[0.0, -100.0, 0.0]])
    rot = jnp.tile(m.QUAT_IDENTITY, (1, 1))
    scene = scene_mod.SphereScene(
        center=center, rotation=rot, prev_center=center, prev_rotation=rot,
        radius=jnp.array([1.0]), materials=mats, textures=packed,
        env=sky.make_environment_light(color=(0.0, 0.0, 0.0, 1.0)),
        mesh=mesh, mesh_instances=mi)
    return scene, mesh


def _tri_rows(lights):
    """(emission, power) of the triangle rows of the compact table, in
    mesh-face (Morton) order recovered via tri_light_id."""
    compact = np.asarray(lights.compact)
    ids = np.asarray(lights.tri_light_id)
    assert (ids >= 0).all(), "every face should make the compact cut"
    return compact[ids, 4:7], compact[ids, 7]


def test_per_face_average_splits_halves():
    """Map = 0.1 on the left half (u < 0.5), 0.9 on the right: a face whose
    UV triangle sits wholly in one half gets exactly that half's value."""
    emis = np.full((32, 32), 0.1, np.float32)
    emis[:, 16:] = 0.9
    scene, _ = _scene_with_uv_mesh(
        [np.array([[0.05, 0.1], [0.40, 0.1], [0.05, 0.9]]),
         np.array([[0.55, 0.1], [0.95, 0.1], [0.55, 0.9]])], emis)
    lights = light_mod.prepare(scene)
    em, power = _tri_rows(lights)
    # Face order after the Morton permute is recovered by tri_light_id, but
    # both faces have identical geometry — identify by value ratio.
    vals = sorted(em[:, 0])
    np.testing.assert_allclose(vals[0], STRENGTH * 0.1, rtol=1e-5)
    np.testing.assert_allclose(vals[1], STRENGTH * 0.9, rtol=1e-5)
    # Equal areas -> power ratio == luminance ratio.
    np.testing.assert_allclose(max(power) / min(power), 9.0, rtol=1e-5)


def test_uniform_map_matches_whole_map_mean():
    emis = np.full((32, 32), 0.7, np.float32)
    scene, _ = _scene_with_uv_mesh(
        [np.array([[0.1, 0.1], [0.8, 0.2], [0.3, 0.9]])], emis)
    em, _ = _tri_rows(light_mod.prepare(scene))
    np.testing.assert_allclose(em[0], STRENGTH * 0.7, rtol=1e-6)


def test_subtexel_face_falls_back_to_centroid_tap():
    """A face smaller than a mip texel (no texel center inside) still gets
    the local map value via the bilinear centroid tap."""
    emis = np.full((32, 32), 0.3, np.float32)
    emis[:, 16:] = 1.0  # far from the tiny triangle at u ~= 0.25
    eps = 1e-3
    scene, _ = _scene_with_uv_mesh(
        [np.array([[0.25, 0.25], [0.25 + eps, 0.25], [0.25, 0.25 + eps]])],
        emis)
    em, _ = _tri_rows(light_mod.prepare(scene))
    np.testing.assert_allclose(em[0], STRENGTH * 0.3, rtol=1e-5)


def test_seam_wrap_invariance():
    """Shifting every U by a texel-aligned offset while rolling the map by
    the same amount must not change any face average — including a face
    whose raw U coordinates cross the u=1 seam."""
    rng = np.random.RandomState(7)
    emis = rng.uniform(0.05, 1.0, (32, 32)).astype(np.float32)
    tris = [np.array([[0.70, 0.2], [1.30, 0.2], [1.00, 0.8]]),  # seam-cross
            np.array([[0.10, 0.3], [0.45, 0.1], [0.30, 0.7]])]
    scene_a, _ = _scene_with_uv_mesh(tris, emis)
    em_a, pw_a = _tri_rows(light_mod.prepare(scene_a))

    shift_tex = 8                      # 8 texels = 0.25 in u
    tris_b = [t + np.array([[shift_tex / 32.0, 0.0]], np.float32)
              for t in tris]
    emis_b = np.roll(emis, shift_tex, axis=1)
    scene_b, _ = _scene_with_uv_mesh(tris_b, emis_b)
    em_b, pw_b = _tri_rows(light_mod.prepare(scene_b))

    np.testing.assert_allclose(em_a, em_b, rtol=1e-5)
    np.testing.assert_allclose(pw_a, pw_b, rtol=1e-5)
