"""Multi-chip sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4: fake a mesh with xla_force_host_platform_device_count)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drts_tpu.parallel import mesh as mesh_mod

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2,
                                reason="needs multiple (virtual) devices")


def test_mesh_and_sharding_rules():
    mesh = mesh_mod.make_mesh(2)
    assert mesh.devices.size == 2
    state = {
        "image": jnp.zeros((16, 32, 3)),     # H divisible by 2 -> sharded
        "scene": jnp.zeros((448, 3)),        # replicated (not image height)
        "scalar": jnp.float32(0.0),
    }
    sharding = mesh_mod.frame_state_sharding(state, mesh,
                                             image_heights=(16,))
    assert sharding["image"].spec == jax.sharding.PartitionSpec(
        "rows", None, None)
    assert sharding["scene"].spec == jax.sharding.PartitionSpec()


def test_sharded_render_matches_single_device():
    """A sharded G-buffer + short trace equals the unsharded result —
    GSPMD must not change the math, only the placement."""
    from drts_tpu.models import myscene
    from drts_tpu.ops import camera as camera_mod, gbuffer, pathtrace

    host = myscene.build(oscillator_grid=1)
    scene = host.scene
    h, w = 16, 32
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 aspect=w / h)
    cfg = pathtrace.PathTraceConfig(width=w, height=h, bounces=1,
                                    block_size=512)

    def render(scene, cam):
        return pathtrace.trace_image(scene, cam, cfg, 0).radiance

    single = jax.jit(render)(scene, cam)

    mesh = mesh_mod.make_mesh(2)
    out_sharding = mesh_mod.image_sharding(mesh)
    sharded_fn = jax.jit(render, out_shardings=out_sharding)
    sharded = sharded_fn(scene, cam)
    assert len(sharded.sharding.device_set) == 2
    np.testing.assert_allclose(np.asarray(single), np.asarray(sharded),
                               atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")
def test_sharded_compact_from_bounce1_matches_single_device():
    """The bounce-1 compaction + coherence sort (compact_from=1) under
    GSPMD row sharding: the full-frame cumsum/permute machinery inserts
    collectives, which must not change the math."""
    import dataclasses

    from drts_tpu.models import myscene
    from drts_tpu.ops import camera as camera_mod, pathtrace

    host = myscene.build(oscillator_grid=1)
    scene = host.scene
    h, w = 16, 32
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 aspect=w / h)
    cfg = pathtrace.PathTraceConfig(width=w, height=h, bounces=4,
                                    block_size=512, compact_from=1,
                                    compact_fraction=4,
                                    compact_fraction_first=1)
    # Partition-sort variant too: it's the large-cap default at 1080p.
    cfg_p = dataclasses.replace(cfg, compact_sort_partition_min=0)

    def render(cfg):
        def f(scene, cam):
            return pathtrace.trace_image(scene, cam, cfg, 5).radiance
        return f

    single = jax.jit(render(cfg))(scene, cam)
    mesh = mesh_mod.make_mesh(4)
    for c in (cfg, cfg_p):
        sharded = jax.jit(render(c),
                          out_shardings=mesh_mod.image_sharding(mesh))(
            scene, cam)
        assert len(sharded.sharding.device_set) == 4
        np.testing.assert_allclose(np.asarray(single), np.asarray(sharded),
                                   atol=1e-5)


def test_dryrun_multichip_small():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as g
    g.dryrun_multichip(2)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_full_pipeline_sharded_matches_single_device():
    """The FULL frame graph (ReSTIR + SHARC + denoise + TAA + bloom) under
    8-way row sharding is numerically equal to the unsharded run — the
    à-trous/TAA/bloom halos cross shard boundaries at 8 rows per device, so
    any GSPMD halo-exchange bug shows up as a value difference (VERDICT r1
    item 8: equality, not just finiteness)."""
    from drts_tpu.models import myscene, pipeline
    from drts_tpu.ops import restir, sharc

    h = w = 64
    cfg = pipeline.PipelineConfig(
        output_width=w, output_height=h, render_width=w, render_height=h,
        bounces=2, samples_per_pixel=1, block_size=1024,
        sharc=sharc.SHARCConfig(capacity_log2=14),
        restir=restir.ReSTIRConfig(regir_cells_per_axis=8,
                                   regir_build_samples=4,
                                   local_light_samples=4))
    pipe = pipeline.RenderPipeline(cfg)
    host = myscene.build(oscillator_grid=3)
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)

    step = jax.jit(lambda s, p: pipe.render_frame(s, p, 1.0 / 60.0))
    s1, img1 = step(state, pose)
    s1, img1 = step(s1, pose)  # second frame exercises temporal history

    mesh = mesh_mod.make_mesh(8)
    state_sharding = mesh_mod.frame_state_sharding(
        state, mesh, image_heights=(h, pipe.cfg.output_height))
    pose_sharding = jax.tree.map(lambda _: mesh_mod.replicated(mesh), pose)
    sharded_step = jax.jit(
        lambda s, p: pipe.render_frame(s, p, 1.0 / 60.0),
        in_shardings=(state_sharding, pose_sharding),
        out_shardings=(state_sharding, mesh_mod.image_sharding(mesh)))
    s8 = jax.device_put(state, state_sharding)
    p8 = jax.device_put(pose, pose_sharding)
    s8, img8 = sharded_step(s8, p8)
    s8, img8 = sharded_step(s8, p8)

    assert len(img8.sharding.device_set) == 8

    # Numeric model (root-caused by stage bisection): GSPMD does not
    # change the math, but the sharded and unsharded programs are
    # DIFFERENT XLA compilations, and at different operand shapes a
    # backend makes different FMA contraction / vectorization choices —
    # legal 1-ULP f32 differences.
    # The denoiser histories are stored f16-packed, so a 1-ULP f32
    # wobble that lands on a rounding boundary quantizes to a full f16 ULP
    # (2^-11 relative ≈ 4.9e-4 at 1.0). The bisect confirms this is the
    # whole story: with ReSTIR and the denoiser disabled the reservoir and
    # SHARC states match BIT-EXACTLY while the f16 TAA history still shows
    # isolated one-ULP flips. A real halo-exchange/collective bug would
    # corrupt whole shard-boundary rows with O(1) error, which the pixel-
    # fraction bound below still catches.
    def assert_f16_close(a, b, name):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
        rel = np.abs(a - b) / scale
        # every value within ~1.5 f16 ULP; ≥99% of pixels f32-tight
        assert rel.max() <= 1.5 * 2.0 ** -11, (name, rel.max())
        frac_loose = (rel > 2e-4).mean()
        assert frac_loose <= 0.01, (name, frac_loose)

    assert_f16_close(img1, img8, "image")
    # Temporal state (denoiser/TAA history) must agree too.
    assert_f16_close(s1.taa.history, s8.taa.history, "taa_history")


def test_multihost_helpers_single_process():
    """multihost.initialize is a no-op without a coordinator; the global
    mesh and local-row bookkeeping degenerate to the single-host mesh."""
    from drts_tpu.parallel import multihost

    assert multihost.initialize() is False
    mesh = multihost.global_mesh()
    assert mesh.devices.size == jax.device_count()
    lo, hi = multihost.process_local_rows(64)
    assert lo == 0 and hi == 64
