"""Light sampling + ReSTIR DI correctness tests (SURVEY.md §7 hard part #3:
reservoir math validated against brute-force direct lighting)."""

import jax
import jax.numpy as jnp
import numpy as np

from drts_tpu.models import scene as scene_mod
from drts_tpu.models.material import MaterialDesc, pack_materials
from drts_tpu.ops import (camera as camera_mod, gbuffer, light as light_mod,
                          restir, sky)
from drts_tpu.utils import math as m


def _two_light_scene():
    """A diffuse floor sphere + two emissive spheres of different power."""
    mats = pack_materials([
        MaterialDesc(base_color=(0.8, 0.8, 0.8, 1), roughness=0.6),
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=5.0,
                     emissive_color=(1.0, 0.2, 0.2)),
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=20.0,
                     emissive_color=(0.2, 0.2, 1.0)),
    ])
    center = jnp.array([[0.0, -100.0, 0.0],
                        [-2.0, 2.0, 0.0],
                        [2.0, 2.0, 0.0]])
    rot = jnp.tile(m.QUAT_IDENTITY, (3, 1))
    return scene_mod.SphereScene(
        center=center, rotation=rot, prev_center=center, prev_rotation=rot,
        radius=jnp.array([99.5, 0.3, 0.3]),
        materials=mats,
        env=sky.make_environment_light(color=(0.0, 0.0, 0.0, 1.0)))


def test_light_prepare_power_cdf():
    scene = _two_light_scene()
    lights = light_mod.prepare(scene)
    p = np.asarray(lights.power)
    assert p[0] == 0.0 and p[1] > 0 and p[2] > p[1]
    # Compact list: brightest first, object ids carried, reverse map right.
    obj = np.asarray(lights.compact[:, 8]).astype(int)
    assert obj[0] == 2 and obj[1] == 1 and (obj[2:] == -1).all()
    lid = np.asarray(lights.table[:, 8]).astype(int)
    assert lid[2] == 0 and lid[1] == 1 and lid[0] == -1
    # CDF sampling proportions match power (indices are compact ids).
    u = jnp.linspace(0.001, 0.999, 20000)
    idx, pdf = light_mod.sample_light_index(lights, u)
    frac_bright = float(jnp.mean((idx == 0).astype(jnp.float32)))
    np.testing.assert_allclose(frac_bright, p[2] / p.sum(), atol=0.01)
    assert float(jnp.min(pdf[idx == 0])) > 0


def test_sphere_light_cone_sampling_hits_sphere():
    scene = _two_light_scene()
    lights = light_mod.prepare(scene)
    n = 5000
    pos = jnp.tile(jnp.array([[0.0, -0.5, 0.0]]), (n, 1))
    idx = jnp.full((n,), 0, jnp.int32)  # compact 0 = brightest = object 2
    u = jnp.stack([jnp.linspace(0.001, 0.999, n)] * 2, axis=-1)
    d, dist, pdf, em = light_mod.sample_sphere_light(lights, idx, pos, u)
    # Every sampled direction must actually hit the light sphere.
    oc = pos - lights.center[2]
    b = m.dot(oc, d)
    c0 = m.dot(oc, oc) - lights.radius[2] ** 2
    disc = b * b - c0
    assert float(jnp.mean((disc > 0).astype(jnp.float32))) > 0.995
    assert float(pdf.min()) > 0
    # PDF integrates to ~1 over the cone: pdf * solid_angle == 1.
    dist_c = float(m.length(pos[0] - lights.center[2]))
    cos_max = np.sqrt(1 - (0.3 / dist_c) ** 2)
    solid = 2 * np.pi * (1 - cos_max)
    np.testing.assert_allclose(float(pdf[0]) * solid, 1.0, rtol=1e-3)


def _render_di(scene, width=48, height=48, frames=1, spatial=True,
               temporal=False, bias_correction="basic",
               offset_mode="per_pixel"):
    cam = camera_mod.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                                 aspect=1.0)
    cfg = restir.ReSTIRConfig(local_light_samples=8,
                              spatial_enabled=spatial,
                              temporal_enabled=temporal,
                              boiling_filter_strength=0.0,
                              spatial_bias_correction=bias_correction,
                              spatial_offset_mode=offset_mode)
    gbuf = gbuffer.generate(scene, cam, width, height, 4096)
    lights = light_mod.prepare(scene)
    surface = restir.make_surface(gbuf)
    def one_frame(f, total):
        grid = restir.build_regir_grid(lights, cam.position, cfg, f)
        res = restir.initial_sampling(surface, scene, lights, grid, cfg, f,
                                      4096)
        if spatial:
            res = restir.spatial_resampling(res, surface, lights, cfg, f,
                                            scene=scene)
        d, s = restir.final_shading(res, surface, scene, lights, 4096)
        return total + d + s

    total = jax.jit(lambda: jax.lax.fori_loop(
        0, frames, one_frame, jnp.zeros((height, width, 3))))()
    return np.asarray(total / frames), gbuf


_BF_CACHE = {}


def _brute_force_di_cached(scene, width=48, height=48, samples=400):
    """The converged reference is identical across the unbiasedness tests
    (same deterministic scene) — compute once per (size, samples)."""
    key = (width, height, samples)
    if key not in _BF_CACHE:
        _BF_CACHE[key] = _brute_force_di(scene, width, height, samples)
    return _BF_CACHE[key]


def _brute_force_di(scene, width=48, height=48, samples=400):
    """Monte-Carlo ground truth: uniform-cone light sampling, no RIS."""
    cam = camera_mod.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                                 aspect=1.0)
    gbuf = gbuffer.generate(scene, cam, width, height, 4096)
    lights = light_mod.prepare(scene)
    surface = restir.make_surface(gbuf)
    from drts_tpu.utils import rng as rng_mod
    h, w = height, width
    px = jnp.arange(w)[None, :] + jnp.zeros((h, 1), jnp.int32)
    py = jnp.arange(h)[:, None] + jnp.zeros((1, w), jnp.int32)
    rng0 = rng_mod.init(px, py, 9999)

    def one_sample(_, carry):
        acc, rng = carry
        u1, rng = rng_mod.next_floats(rng, 1)
        uv, rng = rng_mod.next_floats(rng, 2)
        idx, pick_pdf = light_mod.sample_light_index(lights, u1[..., 0])
        p_hat, direction, dist, diff, spec, em, inv_cone, rows = \
            restir._target_pdf(surface, lights, idx, uv)
        from drts_tpu.ops import intersect
        origin = intersect.safe_spawn_point(
            surface.position, surface.sv.front_geometric_normal, direction)
        occ = restir._occluded(origin, direction, dist, scene, rows.aux,
                               4096)
        cone_pdf = light_mod.light_pdf(lights, idx, surface.position)
        contrib = (diff + spec) * em / jnp.maximum(
            pick_pdf * cone_pdf, 1e-12)[..., None]
        acc = acc + jnp.where((occ | ~surface.valid)[..., None], 0.0,
                              contrib)
        return acc, rng

    acc, _ = jax.jit(lambda: jax.lax.fori_loop(
        0, samples, one_sample, (jnp.zeros((h, w, 3)), rng0)))()
    return np.asarray(acc / samples)


def test_restir_matches_brute_force_pairwise():
    """ReSTIR initial + pairwise-MIS spatial DI is unbiased: averaged over
    frames the scene-mean converges to the brute-force estimate within 2%
    (VERDICT r1 item 6 — the tight statistical-parity bound)."""
    scene = _two_light_scene()
    di, gbuf = _render_di(scene, frames=96, bias_correction="pairwise")
    ref = _brute_force_di_cached(scene, samples=400)
    valid = np.asarray(gbuf.surf.valid)
    lit = valid & (ref.sum(-1) > 1e-3)
    rel = np.abs(di[lit].mean(0) - ref[lit].mean(0)) / (ref[lit].mean(0)
                                                        + 1e-6)
    assert rel.max() < 0.02, (di[lit].mean(0), ref[lit].mean(0))


def test_restir_matches_brute_force_basic():
    """The cheap 1/M spatial mode stays within its documented looser bound
    (slight darkening bias at geometric edges is expected)."""
    scene = _two_light_scene()
    di, gbuf = _render_di(scene, frames=24, bias_correction="basic")
    ref = _brute_force_di_cached(scene, samples=400)
    valid = np.asarray(gbuf.surf.valid)
    lit = valid & (ref.sum(-1) > 1e-3)
    rel = np.abs(di[lit].mean(0) - ref[lit].mean(0)) / (ref[lit].mean(0)
                                                        + 1e-6)
    assert rel.max() < 0.15, (di[lit].mean(0), ref[lit].mean(0))


def test_restir_raytraced_bias_correction_runs():
    """Raytraced mode (pairwise + visibility in the cross terms) produces
    finite output and stays within the pairwise bound."""
    scene = _two_light_scene()
    di, gbuf = _render_di(scene, width=32, height=32, frames=16,
                          bias_correction="raytraced")
    assert np.isfinite(di).all()
    ref = _brute_force_di_cached(scene, width=32, height=32, samples=200)
    valid = np.asarray(gbuf.surf.valid)
    lit = valid & (ref.sum(-1) > 1e-3)
    rel = np.abs(di[lit].mean(0) - ref[lit].mean(0)) / (ref[lit].mean(0)
                                                        + 1e-6)
    assert rel.max() < 0.06, (di[lit].mean(0), ref[lit].mean(0))


def test_restir_temporal_accumulates():
    scene = _two_light_scene()
    cam = camera_mod.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                                 aspect=1.0)
    cfg = restir.ReSTIRConfig(boiling_filter_strength=0.0)
    gbuf = gbuffer.generate(scene, cam, 32, 32, 4096)
    lights = light_mod.prepare(scene)
    surface = restir.make_surface(gbuf)
    depth = jnp.where(jnp.isfinite(gbuf.linear_depth), gbuf.linear_depth,
                      1e8)
    res = restir.init_reservoirs(32, 32)
    for f in range(6):
        grid = restir.build_regir_grid(lights, cam.position, cfg, f)
        cur = restir.initial_sampling(surface, scene, lights, grid, cfg, f,
                                      4096)
        res = restir.temporal_resampling(cur, res, surface, lights,
                                         jnp.zeros((32, 32, 2)), depth,
                                         gbuf.mat.shading_normal, cfg, f)
    m_counts = np.asarray(res.m_count)[np.asarray(surface.valid)]
    # History accumulates beyond one frame's candidate count.
    assert m_counts.max() > cfg.local_light_samples * 2
    # And stays clamped.
    assert m_counts.max() <= cfg.local_light_samples * (cfg.max_history + 1) * 2


def _emissive_mesh_scene():
    """A diffuse floor sphere + an emissive sphere + an emissive QUAD mesh
    (2 triangles) — the mixed-kind light scene for the triangle-light path
    (reference: emissive triangles -> LightInfo,
    LightPreparation.hlsl:86-133)."""
    from drts_tpu.ops import trimesh
    pos = np.array([[-0.5, 0.0, -0.5], [0.5, 0.0, -0.5],
                    [0.5, 0.0, 0.5], [-0.5, 0.0, 0.5]], np.float32)
    nrm = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    tan = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (4, 1))
    mesh = trimesh.make_mesh(pos, nrm, uv, faces, tangents=tan)

    mats = pack_materials([
        MaterialDesc(base_color=(0.8, 0.8, 0.8, 1), roughness=0.6),
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=5.0,
                     emissive_color=(1.0, 0.2, 0.2)),
        # mesh instance material: strong white quad light
        MaterialDesc(base_color=(0, 0, 0, 1), emissive_strength=15.0,
                     emissive_color=(0.9, 0.9, 0.7)),
    ])
    center = jnp.array([[0.0, -100.0, 0.0], [-2.0, 2.0, 0.0]])
    rot = jnp.tile(m.QUAT_IDENTITY, (2, 1))
    mi = scene_mod.MeshInstances(
        center=jnp.array([[1.5, 2.5, 0.0]]),
        rotation=jnp.tile(m.QUAT_IDENTITY, (1, 1)),
        prev_center=jnp.array([[1.5, 2.5, 0.0]]),
        prev_rotation=jnp.tile(m.QUAT_IDENTITY, (1, 1)),
        scale=jnp.array([1.2]))
    return scene_mod.SphereScene(
        center=center, rotation=rot, prev_center=center, prev_rotation=rot,
        radius=jnp.array([99.5, 0.3]),
        materials=mats,
        env=sky.make_environment_light(color=(0.0, 0.0, 0.0, 1.0)),
        mesh=mesh, mesh_instances=mi)


def test_triangle_light_prepare_and_sampling():
    """Triangle lights enter the compact table with area x luminance power;
    area sampling lands on the triangle; uv inversion round-trips."""
    scene = _emissive_mesh_scene()
    lights = light_mod.prepare(scene)
    assert lights.has_triangles
    comp = np.asarray(lights.compact)
    kinds = comp[:, 15]
    powers = comp[:, 7]
    # 2 triangle lights + 1 sphere light present.
    assert (powers > 0).sum() == 3
    assert kinds[powers > 0].sum() == 2
    # Reverse map: both faces of instance 0 map to compact ids.
    tid = np.asarray(lights.tri_light_id)
    assert (tid >= 0).sum() == 2

    # Sample each triangle light from a point below; every sample must lie
    # in the quad's plane (y = 2.5) inside the instance-scaled quad.
    tri_ids = np.nonzero((powers > 0) & (kinds > 0.5))[0]
    n = 2048
    surface_pos = jnp.tile(jnp.array([[0.0, 0.0, 0.0]]), (n, 1))
    u = jnp.stack([jnp.linspace(0.01, 0.99, n)] * 2, axis=-1)
    for t_id in tri_ids:
        rows = light_mod.fetch_rows(lights, jnp.full((n,), int(t_id),
                                                     jnp.int32))
        d, dist, pdf, em = light_mod.sample_light_rows(rows, surface_pos, u)
        p = surface_pos + d * dist[..., None]
        np.testing.assert_allclose(np.asarray(p[:, 1]), 2.5, atol=1e-4)
        assert float(pdf.min()) > 0
        # uv inversion recovers the generating uniforms.
        uv2, inside = light_mod.triangle_uv_from_direction(rows, surface_pos,
                                                           d)
        assert bool(inside.all())
        np.testing.assert_allclose(np.asarray(uv2), np.asarray(u),
                                   atol=1e-3)


def _brute_force_di_generic(scene, width=48, height=48, samples=400):
    """Monte-Carlo DI ground truth for MIXED light kinds: power-CDF light
    pick + kind-dispatched area/cone sampling, pdf taken from the sample
    itself (triangle pdfs depend on the sampled point)."""
    cam = camera_mod.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                                 aspect=1.0)
    gbuf = gbuffer.generate(scene, cam, width, height, 4096)
    lights = light_mod.prepare(scene)
    surface = restir.make_surface(gbuf)
    from drts_tpu.utils import rng as rng_mod
    h, w = height, width
    px = jnp.arange(w)[None, :] + jnp.zeros((h, 1), jnp.int32)
    py = jnp.arange(h)[:, None] + jnp.zeros((1, w), jnp.int32)
    rng0 = rng_mod.init(px, py, 4242)

    def one_sample(_, carry):
        acc, rng = carry
        u1, rng = rng_mod.next_floats(rng, 1)
        uv, rng = rng_mod.next_floats(rng, 2)
        idx, pick_pdf = light_mod.sample_light_index(lights, u1[..., 0])
        p_hat, direction, dist, diff, spec, em, inv_pdf, rows = \
            restir._target_pdf(surface, lights, idx, uv)
        from drts_tpu.ops import intersect
        origin = intersect.safe_spawn_point(
            surface.position, surface.sv.front_geometric_normal, direction)
        occ = restir._occluded(origin, direction, dist, scene, rows.aux,
                               4096)
        contrib = (diff + spec) * em * inv_pdf[..., None] / jnp.maximum(
            pick_pdf, 1e-12)[..., None]
        acc = acc + jnp.where((occ | ~surface.valid)[..., None], 0.0,
                              contrib)
        return acc, rng

    acc, _ = jax.jit(lambda: jax.lax.fori_loop(
        0, samples, one_sample, (jnp.zeros((h, w, 3)), rng0)))()
    return np.asarray(acc / samples), gbuf


def test_restir_emissive_mesh_matches_brute_force():
    """ReSTIR DI over a scene whose dominant light is an emissive MESH
    (triangle lights) stays within the 2% unbiasedness bound vs the
    brute-force estimator (round-2 VERDICT item 4's done criterion)."""
    scene = _emissive_mesh_scene()
    di, gbuf = _render_di(scene, frames=96, bias_correction="pairwise")
    ref, _ = _brute_force_di_generic(scene, samples=400)
    valid = np.asarray(gbuf.surf.valid)
    lit = valid & (ref.sum(-1) > 1e-3)
    rel = np.abs(di[lit].mean(0) - ref[lit].mean(0)) / (ref[lit].mean(0)
                                                        + 1e-6)
    assert rel.max() < 0.02, (di[lit].mean(0), ref[lit].mean(0))


def test_local_light_modes_match_brute_force():
    """Uniform and standalone Power-RIS local-light modes
    (ReSTIRDI_LocalLightSamplingMode, MyAppData.h:35-39) both converge to
    the brute-force estimate — same estimator, different candidate
    source."""
    scene = _two_light_scene()
    ref = _brute_force_di_cached(scene, samples=400)

    for mode in ("Power_RIS", "Uniform"):
        cam = camera_mod.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                                     aspect=1.0)
        cfg = restir.ReSTIRConfig(local_light_samples=8,
                                  local_light_mode=mode,
                                  boiling_filter_strength=0.0,
                                  spatial_bias_correction="pairwise")
        gbuf = gbuffer.generate(scene, cam, 48, 48, 4096)
        lights = light_mod.prepare(scene)
        surface = restir.make_surface(gbuf)

        def one_frame(f, total):
            res = restir.initial_sampling(surface, scene, lights, None,
                                          cfg, f, 4096)
            res = restir.spatial_resampling(res, surface, lights, cfg, f,
                                            scene=scene)
            d, s = restir.final_shading(res, surface, scene, lights, 4096)
            return total + d + s

        di = np.asarray(jax.jit(lambda: jax.lax.fori_loop(
            0, 64, one_frame, jnp.zeros((48, 48, 3))))() / 64)
        valid = np.asarray(gbuf.surf.valid)
        lit = valid & (ref.sum(-1) > 1e-3)
        rel = np.abs(di[lit].mean(0) - ref[lit].mean(0)) / (
            ref[lit].mean(0) + 1e-6)
        assert rel.max() < 0.03, (mode, di[lit].mean(0), ref[lit].mean(0))


def test_temporal_bias_correction_modes_match_brute_force():
    """Temporal pairwise / raytraced MIS modes (the reference's temporal
    BiasCorrectionMode switch, MyAppData.h:226-239): a 48-frame temporal
    chain's time-averaged DI converges to the brute-force estimate — the
    pairwise weights must telescope to a normalized MIS partition or the
    history would systematically brighten/darken."""
    scene = _two_light_scene()
    ref = _brute_force_di_cached(scene, samples=400)
    cam = camera_mod.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                                 aspect=1.0)
    gbuf = gbuffer.generate(scene, cam, 48, 48, 4096)
    lights = light_mod.prepare(scene)
    surface = restir.make_surface(gbuf)
    depth = jnp.where(jnp.isfinite(gbuf.linear_depth), gbuf.linear_depth,
                      1e8)
    motion = jnp.zeros((48, 48, 2))

    for mode in ("pairwise", "raytraced"):
        cfg = restir.ReSTIRConfig(local_light_samples=8,
                                  boiling_filter_strength=0.0,
                                  spatial_enabled=False,
                                  temporal_bias_correction=mode)

        def one_frame(f, carry):
            total, res = carry
            grid = restir.build_regir_grid(lights, cam.position, cfg, f)
            cur = restir.initial_sampling(surface, scene, lights, grid,
                                          cfg, f, 4096)
            res = restir.temporal_resampling(
                cur, res, surface, lights, motion, depth,
                gbuf.mat.shading_normal, cfg, f, scene=scene,
                block_size=4096)
            d, s = restir.final_shading(res, surface, scene, lights, 4096)
            return total + d + s, res

        total, _ = jax.jit(lambda: jax.lax.fori_loop(
            0, 48, one_frame,
            (jnp.zeros((48, 48, 3)), restir.init_reservoirs(48, 48))))()
        di = np.asarray(total / 48)
        valid = np.asarray(gbuf.surf.valid)
        lit = valid & (ref.sum(-1) > 1e-3)
        rel = np.abs(di[lit].mean(0) - ref[lit].mean(0)) / (
            ref[lit].mean(0) + 1e-6)
        assert rel.max() < 0.03, (mode, di[lit].mean(0), ref[lit].mean(0))


def test_temporal_real_prev_surface_matches_brute_force():
    """temporal_prev_surface="real" (the reference's previous-G-buffer
    surface reconstruction, RTXDIAppBridge.hlsli:293-348 previousFrame
    branch): the packed pack_prev_material rows rebuild a usable previous
    surface, and the 48-frame temporal chain with REAL cross-surface
    evaluations converges to the brute-force DI within the pairwise
    bound (static camera: real must agree with pseudo AND with truth)."""
    scene = _two_light_scene()
    ref = _brute_force_di_cached(scene, samples=400)
    cam = camera_mod.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                                 aspect=1.0)
    gbuf = gbuffer.generate(scene, cam, 48, 48, 4096)
    lights = light_mod.prepare(scene)
    surface = restir.make_surface(gbuf)
    depth = jnp.where(jnp.isfinite(gbuf.linear_depth), gbuf.linear_depth,
                      1e8)
    motion = jnp.zeros((48, 48, 2))
    prev_mat = restir.pack_prev_material(gbuf)
    cfg = restir.ReSTIRConfig(local_light_samples=8,
                              boiling_filter_strength=0.0,
                              spatial_enabled=False,
                              temporal_bias_correction="pairwise",
                              temporal_prev_surface="real")

    def one_frame(f, carry):
        total, res = carry
        grid = restir.build_regir_grid(lights, cam.position, cfg, f)
        cur = restir.initial_sampling(surface, scene, lights, grid,
                                      cfg, f, 4096)
        res = restir.temporal_resampling(
            cur, res, surface, lights, motion, depth,
            gbuf.mat.shading_normal, cfg, f, scene=scene,
            block_size=4096, prev_material=prev_mat,
            prev_camera_position=cam.position)
        d, s = restir.final_shading(res, surface, scene, lights, 4096)
        return total + d + s, res

    total, _ = jax.jit(lambda: jax.lax.fori_loop(
        0, 48, one_frame,
        (jnp.zeros((48, 48, 3)), restir.init_reservoirs(48, 48))))()
    di = np.asarray(total / 48)
    valid = np.asarray(gbuf.surf.valid)
    lit = valid & (ref.sum(-1) > 1e-3)
    rel = np.abs(di[lit].mean(0) - ref[lit].mean(0)) / (
        ref[lit].mean(0) + 1e-6)
    assert rel.max() < 0.03, (di[lit].mean(0), ref[lit].mean(0))


def test_hdr_color_rotation_variants():
    """All three ColorPrimaryRotation variants (App.cpp:2216-2225) encode:
    each matrix preserves the white point (rows sum to 1) and the HDR
    signal stays in [0, 1]."""
    from drts_tpu.ops import post
    for name, mat in post.COLOR_ROTATIONS.items():
        rows = np.asarray(mat)
        np.testing.assert_allclose(rows.sum(axis=1), 1.0, atol=2e-3,
                                   err_msg=name)
        img = jnp.abs(jnp.sin(jnp.arange(48.0)).reshape(4, 4, 3))
        out = post.tonemap(img, hdr=True, color_rotation=name)
        assert np.isfinite(np.asarray(out)).all()
        assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0


def test_sharc_roundtrip():
    """SHARC insert -> resolve -> query roundtrip + staleness eviction."""
    from drts_tpu.ops import sharc
    cfg = sharc.SHARCConfig(capacity_log2=14, min_samples_for_query=1.0,
                            max_stale_frames=4)
    state = sharc.init_state(cfg)
    pos = jnp.array([[1.0, 2.0, 3.0], [1.0, 2.0, 3.0], [-5.0, 0.0, 1.0]])
    nrm = jnp.array([[0.0, 1.0, 0.0]] * 3)
    campos = jnp.zeros(3)
    slot, fp = sharc.cache_key(pos, nrm, campos, cfg)
    # Same voxel -> same slot; distant point -> different slot.
    assert int(slot[0]) == int(slot[1])
    assert int(slot[0]) != int(slot[2])

    cap = state.fingerprint.shape[0]
    acc = (jnp.zeros((cap, 3)), jnp.zeros((cap,)), state.fingerprint)
    radiance = jnp.array([[1.0, 2.0, 3.0], [3.0, 2.0, 1.0], [5.0, 5.0, 5.0]])
    acc = sharc.splat(acc, slot, fp, radiance, jnp.ones(3, bool))
    state = sharc.resolve(state, *acc, cfg)

    q, valid = sharc.query(state, pos, nrm, campos, cfg)
    assert bool(valid[0]) and bool(valid[2])
    np.testing.assert_allclose(np.asarray(q[0]), [2.0, 2.0, 2.0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(q[2]), [5.0, 5.0, 5.0], atol=1e-5)

    # Untouched entries go stale and evict after max_stale_frames.
    empty = (jnp.zeros((cap, 3)), jnp.zeros((cap,)), state.fingerprint)
    for _ in range(6):
        state = sharc.resolve(state, *empty, cfg)
    _, valid2 = sharc.query(state, pos, nrm, campos, cfg)
    assert not bool(valid2[0])


def test_sharc_splat_dedup_matches_naive():
    """The group-local dedup before the splat scatter is value-equal to a
    naive per-row scatter-add (heavy duplicate slots, dead lanes, multi
    levels)."""
    from drts_tpu.ops import sharc
    rng = np.random.RandomState(5)
    cap = 1 << 10
    n = 1000  # not a multiple of the dedup group (ragged tail)
    levels = 3
    slots = [jnp.asarray(rng.randint(0, 32, (n,)), jnp.int32)
             for _ in range(levels)]  # heavy collisions
    fps = [jnp.asarray(rng.randint(1, 2**31, (n,)).astype(np.uint32))
           for _ in range(levels)]
    rads = [jnp.asarray(rng.rand(n, 3), jnp.float32)
            for _ in range(levels)]
    acts = [jnp.asarray(rng.rand(n) < 0.7) for _ in range(levels)]

    acc = (jnp.zeros((cap, 3)), jnp.zeros((cap,)),
           jnp.zeros((cap,), jnp.uint32))
    ssum, cnt, _fp, _dropped = sharc.splat_levels(acc, slots, fps, rads,
                                                  acts)

    ref_sum = np.zeros((cap, 3))
    ref_cnt = np.zeros((cap,))
    for s, r, a in zip(slots, rads, acts):
        for i in range(n):
            if bool(a[i]):
                ref_sum[int(s[i])] += np.asarray(r[i])
                ref_cnt[int(s[i])] += 1.0
    np.testing.assert_allclose(np.asarray(ssum), ref_sum, atol=1e-4)
    np.testing.assert_allclose(np.asarray(cnt), ref_cnt, atol=1e-5)


def test_restir_shared_offset_mode_unbiased():
    """The "shared" spatial neighbor mode (one rolled offset per round —
    gather-free addressing, ReSTIRConfig.spatial_offset_mode)
    must stay unbiased: pairwise MIS normalizes the stream for any
    content-independent neighbor choice."""
    scene = _two_light_scene()
    di, gbuf = _render_di(scene, frames=96, bias_correction="pairwise",
                          offset_mode="shared")
    ref = _brute_force_di_cached(scene, samples=400)
    valid = np.asarray(gbuf.surf.valid)
    lit = valid & (ref.sum(-1) > 1e-3)
    rel = np.abs(di[lit].mean(0) - ref[lit].mean(0)) / (ref[lit].mean(0)
                                                        + 1e-6)
    assert rel.max() < 0.02, (di[lit].mean(0), ref[lit].mean(0))


def test_sharc_cached_render_energy_matches_pure_trace():
    """GI energy conservation through the cache: a SHARC-queried render,
    accumulated once the cache is warm, must carry the same mean radiance
    as the pure path trace (the cache stores the SAME integrand, just
    temporally averaged; staleness/quantization bias stays bounded).
    Guards the splat/resolve/query chain end-to-end — the fidelity
    harness can't see a systematic cache bias because both its sides
    share it (round-2 VERDICT weak #4)."""
    from drts_tpu.models import myscene
    from drts_tpu.ops import camera as camera_mod, pathtrace, sharc

    w = h = 64
    host = myscene.build(oscillator_grid=3)
    scene = host.scene
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 horizontal_fov_deg=90.0, aspect=1.0)
    cfg = pathtrace.PathTraceConfig(width=w, height=h, bounces=4,
                                    samples_per_pixel=1, block_size=4096)
    scfg = sharc.SHARCConfig(capacity_log2=16, scene_scale=50.0)

    pure = jax.jit(lambda fi: pathtrace.trace_image(
        scene, cam, cfg, fi).radiance)
    ref = np.zeros((h, w, 3), np.float32)
    n_ref = 24
    for f in range(n_ref):
        ref += np.asarray(pure(f))
    ref /= n_ref

    state = sharc.init_state(scfg)
    upd = jax.jit(lambda st, fi: pathtrace.sharc_update_trace(
        scene, cam, st, scfg, cfg, fi)[0])
    cached_render = jax.jit(lambda st, fi: pathtrace.trace_image(
        scene, cam, cfg, fi, sharc_state=st, sharc_cfg=scfg).radiance)
    out = np.zeros((h, w, 3), np.float32)
    n_out = 16
    for f in range(8):                     # warm the cache
        state = upd(state, f)
    for f in range(n_out):
        state = upd(state, 100 + f)
        out += np.asarray(cached_render(state, 200 + f))
    out /= n_out

    # Mean-energy agreement (cache bias bound); per-pixel noise at these
    # sample counts is large, so compare scene-level means per channel.
    rel = np.abs(out.mean((0, 1)) - ref.mean((0, 1))) \
        / np.maximum(ref.mean((0, 1)), 1e-4)
    assert rel.max() < 0.08, (out.mean((0, 1)), ref.mean((0, 1)))


def test_sharc_update_compact_matches_dense():
    """The compacted+sorted SHARC update trace (compact_from=1) must
    reproduce the dense update's resolved cache: per-path RNG streams are
    identical, so the only differences are splat summation order
    (tolerance) — resolved radiance and occupancy must agree."""
    import dataclasses

    from drts_tpu.models import myscene
    from drts_tpu.ops import camera as camera_mod, pathtrace, sharc

    w = h = 48
    host = myscene.build(oscillator_grid=3)
    scene = host.scene
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 horizontal_fov_deg=90.0, aspect=1.0)
    cfg_d = pathtrace.PathTraceConfig(width=w, height=h, bounces=3,
                                      samples_per_pixel=1, block_size=2304,
                                      compact_from=2)
    cfg_c = dataclasses.replace(cfg_d, compact_from=1)
    scfg = sharc.SHARCConfig(capacity_log2=14, scene_scale=50.0)

    st_d = sharc.init_state(scfg)
    st_c = sharc.init_state(scfg)
    for f in range(3):
        st_d, _ = pathtrace.sharc_update_trace(scene, cam, st_d, scfg,
                                               cfg_d, f)
        st_c, _ = pathtrace.sharc_update_trace(scene, cam, st_c, scfg,
                                               cfg_c, f)
    occ_d = np.asarray(st_d.sample_count > 0)
    occ_c = np.asarray(st_c.sample_count > 0)
    np.testing.assert_array_equal(occ_c, occ_d)
    np.testing.assert_allclose(np.asarray(st_c.radiance),
                               np.asarray(st_d.radiance),
                               rtol=1e-4, atol=1e-5)


def test_candidate_batch_bit_equal():
    """candidate_batch=True is a pure schedule change: identical RNG
    draws, update order, and arithmetic as the sequential candidate loop,
    so reservoir outputs must be bit-identical in BOTH local-light modes
    (ReGIR grid and Power-CDF) and with/without BRDF-candidate MIS."""
    import dataclasses

    scene = _two_light_scene()
    cam = camera_mod.make_camera((0.0, 1.0, -6.0), (0.0, -0.15, 1.0),
                                 aspect=1.0)
    gbuf = gbuffer.generate(scene, cam, 32, 32, 1024)
    lights = light_mod.prepare(scene)
    surface = restir.make_surface(gbuf)
    for mode, n_b in (("ReGIR_RIS", 1), ("Power_RIS", 0)):
        cfg = restir.ReSTIRConfig(local_light_samples=4, brdf_samples=n_b,
                                  local_light_mode=mode,
                                  spatial_enabled=False)
        grid = (restir.build_regir_grid(lights, cam.position, cfg, 0)
                if mode == "ReGIR_RIS" else None)
        seq = restir.initial_sampling(surface, scene, lights, grid, cfg,
                                      0, 1024)
        bat = restir.initial_sampling(
            surface, scene, lights, grid,
            dataclasses.replace(cfg, candidate_batch=True), 0, 1024)
        for name in ("light_index", "uv", "w_sum", "m_count", "phat",
                     "w_out"):
            np.testing.assert_array_equal(
                np.asarray(getattr(seq, name)),
                np.asarray(getattr(bat, name)), err_msg=f"{mode}.{name}")
