"""End-to-end render tests (BASELINE config #1: static scene, 1 spp,
1 bounce) and integrator invariants."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from drts_tpu.models import myscene
from drts_tpu.ops import camera as camera_mod, pathtrace, sky
from drts_tpu.utils import math as m


def _small_setup(width=64, height=64, **kw):
    host = myscene.build(oscillator_grid=3)
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 horizontal_fov_deg=90.0,
                                 aspect=width / height)
    cfg = pathtrace.PathTraceConfig(width=width, height=height,
                                    block_size=4096, **kw)
    return host, cam, cfg


def test_sky_only_render():
    """Camera looking straight up sees only the procedural sky."""
    host, _, cfg = _small_setup(bounces=0)
    cam = camera_mod.make_camera((0.0, 200.0, 0.0), forward=(0.0, 1.0, 0.0),
                                 up=(0.0, 0.0, 1.0), aspect=1.0)
    out = pathtrace.trace_image(host.scene, cam, cfg, 0)
    img = np.asarray(out.radiance)
    expected = np.asarray(sky.procedural_sky(jnp.array([0.0, 1.0, 0.0])))
    center = img[32, 32]
    np.testing.assert_allclose(center, expected, rtol=0.05)
    assert not np.asarray(out.primary_valid).any()


def test_primary_visibility():
    host, cam, cfg = _small_setup(bounces=0)
    out = pathtrace.trace_image(host.scene, cam, cfg, 0)
    valid = np.asarray(out.primary_valid)
    # The sphere field fills a good part of the frame.
    assert 0.05 < valid.mean() < 0.95
    assert np.isfinite(np.asarray(out.radiance)).all()


def test_render_energy_sane_and_jit_consistent():
    host, cam, cfg = _small_setup(bounces=3, samples_per_pixel=1)
    out_eager = pathtrace.trace_image(host.scene, cam, cfg, 0)
    out_jit = pathtrace.trace_image_jit(host.scene, cam, cfg, 0)
    np.testing.assert_allclose(np.asarray(out_eager.radiance),
                               np.asarray(out_jit.radiance),
                               atol=1e-4, rtol=1e-3)
    img = np.asarray(out_jit.radiance)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    # Sky luminance bounds most pixels; emissives may exceed.
    assert np.median(img.sum(-1)) < 10.0
    assert img.mean() > 0.01


def test_spp_reduces_variance():
    host, cam, _ = _small_setup()
    cfg1 = pathtrace.PathTraceConfig(width=48, height=48, bounces=4,
                                     samples_per_pixel=1, block_size=4096)
    cfg8 = dataclasses.replace(cfg1, samples_per_pixel=8)
    frames1 = [np.asarray(pathtrace.trace_image(host.scene, cam, cfg1,
                                                i).radiance)
               for i in range(3)]
    frames8 = [np.asarray(pathtrace.trace_image(host.scene, cam, cfg8,
                                                i).radiance)
               for i in range(3)]
    var1 = np.var(np.stack(frames1), axis=0).mean()
    var8 = np.var(np.stack(frames8), axis=0).mean()
    assert var8 < var1 * 0.5


def test_accumulation_converges():
    """Static scene: averaging N independent frames must converge to the
    same image regardless of seed partition (unbiasedness smoke test)."""
    host, cam, _ = _small_setup()
    cfg = pathtrace.PathTraceConfig(width=32, height=32, bounces=2,
                                    samples_per_pixel=2, block_size=4096)
    acc_a = np.zeros((32, 32, 3))
    acc_b = np.zeros((32, 32, 3))
    for i in range(8):
        acc_a += np.asarray(pathtrace.trace_image(host.scene, cam, cfg,
                                                  i).radiance)
        acc_b += np.asarray(pathtrace.trace_image(host.scene, cam, cfg,
                                                  100 + i).radiance)
    diff = np.abs(acc_a - acc_b).mean() / max(acc_a.mean(), 1e-9)
    assert diff < 0.25


def test_glass_sphere_transmits():
    """A single smooth glass sphere in front of the sky must transmit most
    of the background (throughput = base_color for the transmission lobe)."""
    from drts_tpu.models import scene as scene_mod
    from drts_tpu.models.material import MaterialDesc, pack_materials
    mats = pack_materials([MaterialDesc(base_color=(1, 1, 1, 1),
                                        roughness=0.0, transmission=1.0)])
    center = jnp.array([[0.0, 0.0, 0.0]])
    rot = jnp.tile(m.QUAT_IDENTITY, (1, 1))
    sc = scene_mod.SphereScene(
        center=center, rotation=rot, prev_center=center, prev_rotation=rot,
        radius=jnp.array([1.0]), materials=mats,
        env=sky.make_environment_light())
    cam = camera_mod.make_camera((0.0, 0.0, -4.0), aspect=1.0)
    cfg = pathtrace.PathTraceConfig(width=32, height=32, bounces=8,
                                    samples_per_pixel=4, block_size=4096)
    out = pathtrace.trace_image(sc, cam, cfg, 0)
    img = np.asarray(out.radiance)
    sky_lum = float(np.asarray(m.luminance(
        sky.procedural_sky(jnp.array([0.0, 0.0, 1.0])))))
    center_lum = img[16, 16] @ [0.2126, 0.7152, 0.0722]
    assert center_lum > 0.4 * sky_lum


def test_compact_wavefront_matches_dense():
    """The compacted deep-bounce wavefront (PathTraceConfig.compact_from)
    must reproduce the masked-dense integrator: identical RNG streams per
    path => same radiance up to summation order."""
    host, cam, _ = _small_setup()
    cfg_dense = pathtrace.PathTraceConfig(width=64, height=64, bounces=6,
                                          block_size=4096, compact_from=99)
    cfg_compact = dataclasses.replace(cfg_dense, compact_from=2,
                                      compact_fraction=4)
    out_d = pathtrace.trace_image(host.scene, cam, cfg_dense, 3)
    out_c = pathtrace.trace_image(host.scene, cam, cfg_compact, 3)
    np.testing.assert_allclose(np.asarray(out_c.radiance),
                               np.asarray(out_d.radiance),
                               rtol=1e-4, atol=1e-5)
    assert float(out_c.rays_traced) == float(out_d.rays_traced)


def test_compact_sort_is_invisible():
    """The (octant, tile) coherence sort of the compacted deep-bounce buffer
    only re-orders slots; every per-path op is lane-independent, so radiance
    must be bitwise identical with the sort on or off."""
    host, cam, _ = _small_setup()
    cfg_off = pathtrace.PathTraceConfig(width=64, height=64, bounces=6,
                                        block_size=4096, compact_from=2,
                                        compact_fraction=4,
                                        compact_sort=False)
    cfg_on = dataclasses.replace(cfg_off, compact_sort=True,
                                 compact_sort_tile=16)
    out_off = pathtrace.trace_image(host.scene, cam, cfg_off, 3)
    out_on = pathtrace.trace_image(host.scene, cam, cfg_on, 3)
    np.testing.assert_array_equal(np.asarray(out_on.radiance),
                                  np.asarray(out_off.radiance))
    assert float(out_on.rays_traced) == float(out_off.rays_traced)


def test_compact_sort_partition_is_invisible():
    """The stable 9-bucket octant partition (large-capacity replacement
    for the (octant, tile) key sort) is also just a slot permutation:
    radiance must be bitwise identical to the sort-off baseline."""
    host, cam, _ = _small_setup()
    cfg_off = pathtrace.PathTraceConfig(width=64, height=64, bounces=6,
                                        block_size=4096, compact_from=2,
                                        compact_fraction=4,
                                        compact_sort=False)
    cfg_part = dataclasses.replace(cfg_off, compact_sort=True,
                                   compact_sort_partition_min=0)
    out_off = pathtrace.trace_image(host.scene, cam, cfg_off, 3)
    out_p = pathtrace.trace_image(host.scene, cam, cfg_part, 3)
    np.testing.assert_array_equal(np.asarray(out_p.radiance),
                                  np.asarray(out_off.radiance))
    assert float(out_p.rays_traced) == float(out_off.rays_traced)


def test_compact_from_bounce1_matches_dense():
    """compact_from=1 (bounce-1 segment + deep re-compaction) reproduces
    the masked-dense integrator exactly like compact_from=2 does: per-path
    RNG streams are carried through both segments, so radiance, the
    bounce-1 AOVs, and the ray count must all agree."""
    host, cam, _ = _small_setup()
    cfg_dense = pathtrace.PathTraceConfig(width=64, height=64, bounces=6,
                                          block_size=4096, compact_from=99)
    cfg_b1 = dataclasses.replace(cfg_dense, compact_from=1,
                                 compact_fraction=4,
                                 compact_fraction_first=1)
    out_d = pathtrace.trace_image(host.scene, cam, cfg_dense, 3)
    out_c = pathtrace.trace_image(host.scene, cam, cfg_b1, 3)
    np.testing.assert_allclose(np.asarray(out_c.radiance),
                               np.asarray(out_d.radiance),
                               rtol=1e-4, atol=1e-5)
    assert float(out_c.rays_traced) == float(out_d.rays_traced)
    np.testing.assert_array_equal(np.asarray(out_c.is_diffuse),
                                  np.asarray(out_d.is_diffuse))
    hd_c = np.asarray(out_c.hit_distance)
    hd_d = np.asarray(out_d.hit_distance)
    both_finite = np.isfinite(hd_c) & np.isfinite(hd_d)
    assert (np.isfinite(hd_c) == np.isfinite(hd_d)).all()
    np.testing.assert_allclose(hd_c[both_finite], hd_d[both_finite],
                               rtol=1e-5, atol=1e-6)


def test_compact_from_bounce1_di_handoff_matches_dense():
    """The ReSTIR DI handoff (bounce-1 emission suppression where DI was
    added at the primary vertex, Raytracing.hlsl:302) must survive the
    bounce-1 compaction: di_valid rides the slot gather."""
    host, cam, _ = _small_setup()
    di = jnp.full((64, 64, 3), 0.25, jnp.float32)
    cfg_dense = pathtrace.PathTraceConfig(width=64, height=64, bounces=4,
                                          block_size=4096, compact_from=99)
    cfg_b1 = dataclasses.replace(cfg_dense, compact_from=1,
                                 compact_fraction=4,
                                 compact_fraction_first=1)
    out_d = pathtrace.trace_image(host.scene, cam, cfg_dense, 7,
                                  di_radiance=di)
    out_c = pathtrace.trace_image(host.scene, cam, cfg_b1, 7,
                                  di_radiance=di)
    np.testing.assert_allclose(np.asarray(out_c.radiance),
                               np.asarray(out_d.radiance),
                               rtol=1e-4, atol=1e-5)


def test_compact_from_bounce1_single_bounce():
    """compact_from=1 with bounces=1 exercises the single-segment
    final-emission path (no continuation state)."""
    host, cam, _ = _small_setup()
    cfg_dense = pathtrace.PathTraceConfig(width=64, height=64, bounces=1,
                                          block_size=4096, compact_from=99)
    cfg_b1 = dataclasses.replace(cfg_dense, compact_from=1,
                                 compact_fraction_first=1)
    out_d = pathtrace.trace_image(host.scene, cam, cfg_dense, 5)
    out_c = pathtrace.trace_image(host.scene, cam, cfg_b1, 5)
    np.testing.assert_allclose(np.asarray(out_c.radiance),
                               np.asarray(out_d.radiance),
                               rtol=1e-4, atol=1e-5)
    assert float(out_c.rays_traced) == float(out_d.rays_traced)


def test_compact_wavefront_overflow_drops_not_corrupts():
    """With a pathological 1-lane capacity, overflow rays are dropped
    (documented energy loss), never corrupting other pixels."""
    host, cam, _ = _small_setup()
    cfg = pathtrace.PathTraceConfig(width=64, height=64, bounces=4,
                                    block_size=4096, compact_from=2,
                                    compact_fraction=64 * 64)
    out = pathtrace.trace_image(host.scene, cam, cfg, 3)
    r = np.asarray(out.radiance)
    assert np.isfinite(r).all()
    assert r.min() >= 0.0


def test_overflow_spill_recovers_dropped_radiance():
    """VERDICT r4 item #8: with overflow_spill on, a capacity the
    survivors exceed no longer silently darkens GI — the second wave
    processes the dropped lanes and the result matches the masked-dense
    integrator exactly (same per-path RNG streams)."""
    # 128x128: the 64px viewport leaves < 64 bounce-2 survivors in this
    # scene — too few to exercise overflow at any aligned capacity.
    host, cam, _ = _small_setup(width=128, height=128)
    # Spill is pinned OFF in the base config: the probe's self-calibration
    # and the `tight` drop baseline both need the raw wave-0 overflow
    # counter (with the now-default spill ON, wave 1 absorbs it and the
    # counter reports only the residual past 2x capacity).
    dense = pathtrace.PathTraceConfig(width=128, height=128, bounces=4,
                                      block_size=4096, compact_from=99,
                                      overflow_spill=False)
    # Self-calibrating capacity: a probe run at the smallest capacity
    # reports survivors - cap in the overflow counter, from which we pick
    # a capacity where wave 0 overflows but 2x covers all survivors — so
    # the test can't rot into vacuity if the scene changes.
    probe = dataclasses.replace(dense, compact_from=2, compact_capacity=64)
    out_p = pathtrace.trace_image(host.scene, cam, probe, 3)
    survivors = 64 + int(out_p.counters["wavefront_overflow_paths"])
    assert survivors > 96, "probe scene too empty for an overflow test"
    cap = max(64, ((survivors - 1) // 2) // 64 * 64 + 64)
    assert cap < survivors <= 2 * cap
    tight = dataclasses.replace(dense, compact_from=2,
                                compact_capacity=cap)
    spill = dataclasses.replace(tight, overflow_spill=True)
    out_d = pathtrace.trace_image(host.scene, cam, dense, 3)
    out_t = pathtrace.trace_image(host.scene, cam, tight, 3)
    out_s = pathtrace.trace_image(host.scene, cam, spill, 3)
    drop_t = float(out_t.counters["wavefront_overflow_paths"])
    drop_s = float(out_s.counters["wavefront_overflow_paths"])
    assert drop_t > 0.0            # wave 0 really overflowed
    assert drop_s == 0.0           # wave 1 caught everything
    # Dropped paths lose radiance; spilled paths restore dense parity.
    assert (np.asarray(out_t.radiance).sum()
            < np.asarray(out_d.radiance).sum())
    np.testing.assert_allclose(np.asarray(out_s.radiance),
                               np.asarray(out_d.radiance),
                               rtol=1e-4, atol=1e-5)
    assert float(out_s.rays_traced) == float(out_d.rays_traced)


def test_compact_gsel_mono_is_invisible():
    """compact_gsel="mono" only reschedules the slot state gathers
    (monotone big-table pull + small-table perm gather); the gathered
    values are identical by construction (src_sorted[p] =
    src_rank[perm[p]]), so radiance must be bitwise identical — under
    both the key sort and the 9-bucket partition."""
    host, cam, _ = _small_setup()
    base = pathtrace.PathTraceConfig(width=64, height=64, bounces=6,
                                     block_size=4096, compact_from=2,
                                     compact_fraction=4,
                                     compact_sort_tile=16)
    out_d = pathtrace.trace_image(host.scene, cam, base, 3)
    for extra in ({}, {"compact_sort_partition_min": 0}):
        cfg_m = dataclasses.replace(base, compact_gsel="mono", **extra)
        out_m = pathtrace.trace_image(host.scene, cam, cfg_m, 3)
        np.testing.assert_array_equal(np.asarray(out_m.radiance),
                                      np.asarray(out_d.radiance))
        assert float(out_m.rays_traced) == float(out_d.rays_traced)


def test_compact_impl_equivalence():
    """All src-table builders ("scatter", "two_level", "blocked_sort")
    must produce identical compaction outputs — src,
    keep/pos, slot_live, overflow — on a scattered live mask, with the
    coherence sort on and off, and across capacity-overflow waves."""
    import jax.numpy as jnp

    ns, cap = 40960, 1024
    rng_np = np.random.RandomState(5)
    act = jnp.asarray(rng_np.rand(ns) < 0.04)
    dirs = jnp.asarray(rng_np.randn(ns, 3).astype(np.float32))
    for sort in (False, True):
        for wave in (0, 1):
            outs = {}
            for impl in ("scatter", "two_level", "blocked_sort"):
                cfg = pathtrace.PathTraceConfig(
                    width=256, height=160, compact_impl=impl,
                    compact_sort=sort)
                cs = pathtrace._compact_slots(act, dirs, None, cfg, cap,
                                              160, 256, wave=wave)
                outs[impl] = jax.tree.map(
                    np.asarray, (cs["src"], cs["slot_live"], cs["keep"],
                                 cs["pos"], cs["overflow"]))
            base = outs["scatter"]
            for impl, got in outs.items():
                for a, b in zip(base, got):
                    np.testing.assert_array_equal(a, b, err_msg=impl)
