"""Triangle-mesh path tests: Möller-Trumbore, instancing, interpolation."""

import jax.numpy as jnp
import numpy as np
import pytest

from drts_tpu.models import geometry
from drts_tpu.ops import intersect, trimesh
from drts_tpu.utils import math as m


def _unit_geosphere(tess=3):
    pos, nrm, uv, idx = geometry.create_geosphere(2.0, tess)  # radius 1
    return trimesh.make_mesh(pos, nrm, uv, idx)


def test_single_triangle():
    mesh = trimesh.make_mesh(
        positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        normals=np.array([[0, 0, -1]] * 3, np.float32),
        uvs=np.array([[0, 0], [1, 0], [0, 1]], np.float32),
        faces=np.array([[0, 1, 2]], np.int32))
    o = jnp.array([[0.25, 0.25, -2.0], [0.9, 0.9, -2.0]])
    d = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t, face, u, v = trimesh.intersect_mesh(o, d, jnp.zeros(2),
                                           jnp.full((2,), 1e9), mesh)
    assert np.isfinite(float(t[0])) and float(t[0]) == 2.0
    assert not np.isfinite(float(t[1]))  # outside the triangle
    np.testing.assert_allclose([float(u[0]), float(v[0])], [0.25, 0.25],
                               atol=1e-5)


def test_geosphere_matches_analytic_sphere():
    """Triangle geosphere hits must match the analytic sphere within the
    tessellation error."""
    mesh = _unit_geosphere(4)
    rng = np.random.RandomState(0)
    n = 500
    o = jnp.asarray(rng.randn(n, 3), jnp.float32) * 0.5 \
        + jnp.array([0.0, 0.0, -5.0])
    d = m.normalize(jnp.array([[0.0, 0.0, 1.0]]) * jnp.ones((n, 1))
                    + 0.1 * jnp.asarray(rng.randn(n, 3), jnp.float32))
    t_tri, face, u, v = trimesh.intersect_mesh(o, d, jnp.zeros(n),
                                               jnp.full((n,), 1e9), mesh)
    sph = intersect.intersect_spheres(o, d, jnp.zeros(n),
                                      jnp.full((n,), 1e9),
                                      jnp.zeros((1, 3)), jnp.ones(1))
    hit_tri = np.isfinite(np.asarray(t_tri))
    hit_sph = np.asarray(sph.hit)
    # Same hit classification away from silhouettes (>97%).
    assert (hit_tri == hit_sph).mean() > 0.97
    both = hit_tri & hit_sph
    # Tessellation chord error grows at grazing incidence; 2% covers it.
    np.testing.assert_allclose(np.asarray(t_tri)[both],
                               np.asarray(sph.t)[both], rtol=0.02)


def test_instanced_meshes_and_attributes():
    mesh = _unit_geosphere(3)
    pos = jnp.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    rot = jnp.tile(m.QUAT_IDENTITY, (2, 1))
    scale = jnp.array([1.0, 0.5])
    o = jnp.array([[0.0, 0.0, -5.0], [3.0, 0.0, -5.0]])
    d = jnp.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    hit = trimesh.intersect_instances(o, d, jnp.zeros(2),
                                      jnp.full((2,), 1e9), mesh, pos, rot,
                                      scale)
    assert bool(hit.hit[0]) and bool(hit.hit[1])
    assert int(hit.instance[0]) == 0 and int(hit.instance[1]) == 1
    np.testing.assert_allclose(float(hit.t[0]), 4.0, atol=0.05)
    np.testing.assert_allclose(float(hit.t[1]), 4.5, atol=0.05)
    normal, uv, tangent = trimesh.interpolate_attributes(mesh, hit, rot)
    np.testing.assert_allclose(np.asarray(normal[0]), [0, 0, -1], atol=0.05)
    assert abs(float(m.dot(normal[0], tangent[0]))) < 0.1
    assert 0.0 <= float(uv[0, 0]) <= 1.0


def test_as_mesh_scene_renders():
    """The demo scene converted to 100% instanced triangle meshes
    (myscene.as_mesh_scene — the reference's actual geosphere BLAS
    workload) renders finite radiance that tracks the sphere-scene render
    (chord error aside)."""
    import jax.numpy as jnp
    from drts_tpu.models import myscene
    from drts_tpu.ops import camera as camera_mod, pathtrace

    host = myscene.build(oscillator_grid=2)
    mh = myscene.as_mesh_scene(host, tessellation=2)
    assert mh.scene.center.shape[0] == 0
    assert mh.scene.mesh_instances.center.shape[0] == host.scene.center.shape[0]
    cam = camera_mod.make_camera(mh.camera_position, mh.camera_forward,
                                 horizontal_fov_deg=90.0, aspect=1.0)
    cfg = pathtrace.PathTraceConfig(width=48, height=48, bounces=2,
                                    samples_per_pixel=1, block_size=2304)
    out = pathtrace.trace_image(mh.scene, cam, cfg, 0)
    r = np.asarray(out.radiance)
    assert np.isfinite(r).all()
    out_s = pathtrace.trace_image(host.scene, cam, cfg, 0)
    rs = np.asarray(out_s.radiance)
    # Same scene, tessellated: hit maps agree away from silhouettes and
    # mean radiance is in the same ballpark.
    agree = (np.asarray(out.primary_valid)
             == np.asarray(out_s.primary_valid)).mean()
    assert agree > 0.85
    assert abs(r.mean() - rs.mean()) / max(rs.mean(), 1e-6) < 0.25


def _instanced_scene(seed, k=24, n=4096, ground=True):
    """Random instanced scene with the hard cases of the instance loop's
    bounding-sphere cull: a huge ground-like instance whose bound contains
    most ray origins, overlapping bounds, and rays spawned on instance
    surfaces (secondary-bounce geometry)."""
    rng = np.random.RandomState(seed)
    mesh = _unit_geosphere(3)
    pos = rng.randn(k, 3).astype(np.float32) * 6
    scale = (0.4 + rng.rand(k) * 1.4).astype(np.float32)
    if ground:
        pos[0] = [0.0, -100.0, 0.0]
        scale[0] = 99.0  # bound contains every origin below
    rot = m.normalize(jnp.asarray(rng.randn(k, 4), jnp.float32))
    o = rng.randn(n, 3).astype(np.float32) * 8
    # Half the rays start ON a random instance surface (inside its bound).
    half = n // 2
    which = rng.randint(0, k, half)
    dir_out = rng.randn(half, 3)
    dir_out /= np.linalg.norm(dir_out, axis=1, keepdims=True)
    o[:half] = pos[which] + dir_out * scale[which][:, None] * 1.001
    d = m.normalize(jnp.asarray(rng.randn(n, 3), jnp.float32))
    return (mesh, jnp.asarray(pos), rot, jnp.asarray(scale),
            jnp.asarray(o), d)


def test_per_vertex_motion_vectors():
    """Deforming-mesh motion vectors (GBufferGeneration.hlsl:62-91
    vertex-motion path): a mesh whose vertices all carry a constant
    object-space prev-minus-current displacement must produce G-buffer
    motion equal to the projected displacement; without vertex_motion
    (rigid) the static scene's motion is zero."""
    import dataclasses
    import jax.numpy as jnp
    from drts_tpu.models import geometry, scene as scene_mod, myscene
    from drts_tpu.ops import camera as camera_mod, gbuffer

    host = myscene.build(oscillator_grid=2)
    base = myscene.as_mesh_scene(host, tessellation=2)

    w = h = 64
    cam = camera_mod.make_camera(base.camera_position, base.camera_forward,
                                 horizontal_fov_deg=90.0, aspect=1.0)

    # Rigid static scene: prev pose == pose, no vertex motion -> zero MVs.
    g0 = gbuffer.generate(base.scene, cam, w, h, 4096)
    valid0 = np.asarray(g0.surf.valid)
    assert valid0.any()
    np.testing.assert_allclose(np.asarray(g0.motion)[valid0], 0.0,
                               atol=1e-2)

    # Same mesh with constant object-space vertex motion d: expected
    # previous world position = hit + R*(d*scale); motion = prev_px-cur_px.
    d_obj = np.array([0.12, -0.07, 0.05], np.float32)
    mesh = base.scene.mesh
    vm = np.tile(d_obj, (np.asarray(mesh.positions).shape[0], 1))
    mesh_vm = dataclasses.replace(mesh, vertex_motion=jnp.asarray(vm))
    scene_vm = dataclasses.replace(base.scene, mesh=mesh_vm)
    g1 = gbuffer.generate(scene_vm, cam, w, h, 4096)
    valid1 = np.asarray(g1.surf.valid)
    np.testing.assert_array_equal(valid0, valid1)

    from drts_tpu.utils import math as m
    mi = base.scene.mesh_instances
    k = base.scene.center.shape[0]
    inst = jnp.asarray(np.asarray(g1.surf.object_index) - k)
    rot = mi.rotation[inst]
    scale = mi.scale[inst][..., None]
    prev_world = g1.surf.position + m.quat_rotate(
        rot, jnp.broadcast_to(jnp.asarray(d_obj), g1.surf.position.shape)
        * scale)
    prev_ndc, _ = camera_mod.project_to_ndc(cam, prev_world, previous=True)
    cur_ndc, _ = camera_mod.project_to_ndc(cam, g1.surf.position,
                                           previous=False)
    exp = np.asarray(camera_mod.ndc_to_pixel(prev_ndc, w, h)
                     - camera_mod.ndc_to_pixel(cur_ndc, w, h))
    got = np.asarray(g1.motion)
    np.testing.assert_allclose(got[valid1], exp[valid1], atol=2e-2)
    # And it actually moved (non-zero motion somewhere).
    assert np.abs(got[valid1]).max() > 0.05


def _per_instance_reference(o, d, tmin, tmax, mesh, pos, rot, scale):
    """Closest hit over instances, each instance swept alone over the full
    ray range (no cull), the nearest kept in numpy."""
    ts, faces, insts = [], [], []
    for i in range(pos.shape[0]):
        inv = m.quat_conj(rot[i])
        o_l = m.quat_rotate(inv, o - pos[i]) / scale[i]
        d_l = m.quat_rotate(inv, d) / scale[i]
        t, face, _, _ = trimesh.intersect_mesh(o_l, d_l, tmin, tmax, mesh)
        ts.append(np.asarray(t))
        faces.append(np.asarray(face))
    ts = np.stack(ts)
    best = ts.argmin(0)
    lanes = np.arange(ts.shape[1])
    return ts[best, lanes], np.stack(faces)[best, lanes], best


@pytest.mark.parametrize("seed,ground,bounded", [
    (7, True, False), (11, False, False), (13, True, True)])
def test_instance_loop_matches_per_instance_reference(seed, ground, bounded):
    """The fori_loop instance sweep (with its running-best bounding-sphere
    cull) finds the same closest hit as sweeping each instance alone."""
    mesh, pos, rot, scale, o, d = _instanced_scene(seed, k=12, n=1024,
                                                   ground=ground)
    n = o.shape[0]
    tmin = jnp.zeros(n)
    tmax = (jnp.asarray(np.random.RandomState(seed).rand(n) * 15,
                        jnp.float32) if bounded else jnp.full((n,), 1e9))
    got = trimesh.intersect_instances(o, d, tmin, tmax, mesh, pos, rot,
                                      scale)
    t_ref, face_ref, inst_ref = _per_instance_reference(
        o, d, tmin, tmax, mesh, pos, rot, scale)
    hit_ref = np.isfinite(t_ref)
    np.testing.assert_array_equal(np.asarray(got.hit), hit_ref)
    # Same arithmetic, compiled in another program: XLA may fuse (and so
    # round) differently, a few f32 ulps of relative error.
    np.testing.assert_allclose(np.asarray(got.t)[hit_ref], t_ref[hit_ref],
                               rtol=1e-4)
    same = ((np.asarray(got.instance) == inst_ref)
            & (np.asarray(got.face) == face_ref))[hit_ref]
    assert same.mean() > 0.999, same.mean()


def test_instances_any_is_closest_hit_bit():
    """Any-hit over instances = the closest-hit sweep's hit bit, with
    bounded, unbounded and dead (tmax < tmin) rays."""
    mesh, pos, rot, scale, o, d = _instanced_scene(5, k=10, n=512)
    rng = np.random.RandomState(5)
    tmax = jnp.asarray(np.where(rng.rand(512) < 0.3, 1e9,
                                np.where(rng.rand(512) < 0.5,
                                         rng.rand(512) * 12, -1.0)),
                       jnp.float32)
    tmin = jnp.zeros(512)
    occ = np.asarray(trimesh.intersect_instances_any(o, d, tmin, tmax, mesh,
                                                     pos, rot, scale))
    t_ref, _, _ = _per_instance_reference(o, d, tmin, tmax, mesh, pos, rot,
                                          scale)
    np.testing.assert_array_equal(occ, np.isfinite(t_ref))
    assert not occ[np.asarray(tmax) < 0].any()


@pytest.mark.parametrize("ray_block,face_block", [(7, 16), (64, 50),
                                                  (4096, 512)])
def test_mesh_sweep_blocking_is_result_invariant(ray_block, face_block):
    """Ray and face block sizes (padding included) change the schedule,
    not the hits."""
    mesh = _unit_geosphere(3)
    rng = np.random.RandomState(2)
    n = 300
    o = jnp.asarray(rng.randn(n, 3) * 3, jnp.float32)
    d = m.normalize(jnp.asarray(rng.randn(n, 3), jnp.float32))
    args = (o, d, jnp.zeros(n), jnp.full((n,), 1e9), mesh)
    t0, f0, u0, v0 = trimesh.intersect_mesh(*args, ray_block=n,
                                            face_block=mesh.v0.shape[0])
    t1, f1, u1, v1 = trimesh.intersect_mesh(*args, ray_block=ray_block,
                                            face_block=face_block)
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t0))
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f0))
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u0))


def test_morton_face_order_is_a_permutation_of_the_geometry():
    pos, nrm, uv, idx = geometry.create_geosphere(2.0, 3)
    mesh = trimesh.make_mesh(pos, nrm, uv, idx)
    key = lambda f: sorted(map(tuple, np.asarray(f)))  # noqa: E731
    assert key(mesh.faces) == key(idx)
    np.testing.assert_allclose(
        np.asarray(mesh.v0), np.asarray(pos)[np.asarray(mesh.faces)[:, 0]])
    # Consecutive faces are spatially close: mean centroid step well under
    # the mean distance between random faces.
    cent = np.asarray(mesh.v0 + (mesh.e1 + mesh.e2) / 3.0)
    step = np.linalg.norm(np.diff(cent, axis=0), axis=1).mean()
    rand = np.linalg.norm(cent - cent[::-1], axis=1).mean()
    assert step < 0.5 * rand
