"""End-to-end pipeline, checkpoint/resume, timer, and native-lib tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from drts_tpu.models import myscene, pipeline
from drts_tpu.ops import sharc


def _tiny_pipeline(denoiser="NRDReBLUR", restir=True, sharc_on=True,
                   upscale=False):
    cfg = pipeline.PipelineConfig(
        output_width=64 if upscale else 32,
        output_height=64 if upscale else 32,
        render_width=32, render_height=32,
        bounces=2, samples_per_pixel=1, denoiser=denoiser,
        upscaling=upscale, block_size=2048,
        restir_enabled=restir,
        sharc_enabled=sharc_on,
        sharc=sharc.SHARCConfig(capacity_log2=12),
        sharc_downscale=2)
    pipe = pipeline.RenderPipeline(cfg)
    host = myscene.build(oscillator_grid=2)
    return pipe, host


_DEFAULT = None


def _tiny_default():
    """Default tiny pipeline + ONE jitted step, shared across tests —
    the full-graph CPU compile dominates suite time on the 1-vCPU box."""
    global _DEFAULT
    if _DEFAULT is None:
        pipe, host = _tiny_pipeline()
        step = jax.jit(lambda s, p: pipe.render_frame(s, p, 1.0 / 60.0))
        _DEFAULT = (pipe, host, step)
    return _DEFAULT


def test_full_pipeline_frames():
    """Full frame graph (physics + ReSTIR + SHARC + trace + denoise +
    post) produces finite images and advances state."""
    pipe, host, step = _tiny_default()
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)
    for i in range(3):
        state, img = step(state, pose)
        arr = np.asarray(img)
        assert arr.shape == (32, 32, 3)
        assert np.isfinite(arr).all()
        assert arr.min() >= 0.0 and arr.max() <= 1.0
    assert int(state.frame_index) == 3
    # Physics advanced the scene.
    assert not np.allclose(np.asarray(state.scene.center),
                           np.asarray(host.scene.center))
    # SHARC cache got populated.
    assert float(state.sharc.sample_count.sum()) > 0


def test_pipeline_no_denoise_upscale():
    pipe, host = _tiny_pipeline(denoiser="None", restir=False,
                                sharc_on=False, upscale=True)
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)
    state, img = pipe.render_frame(state, pose, 1.0 / 60.0)
    assert img.shape == (64, 64, 3)
    assert np.isfinite(np.asarray(img)).all()


def test_reset_history():
    pipe, host, step = _tiny_default()
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)
    state, _ = step(state, pose)
    state2 = pipe.reset_history(state)
    assert float(state2.denoiser.history_length.max()) == 0.0
    assert float(state2.sharc.sample_count.max()) == 0.0
    assert float(state2.taa.history.max()) == 0.0
    # Physics/scene state survives a history reset.
    np.testing.assert_array_equal(np.asarray(state2.scene.center),
                                  np.asarray(state.scene.center))


def test_checkpoint_roundtrip(tmp_path):
    from drts_tpu.utils import checkpoint
    pipe, host = _tiny_pipeline(restir=False, sharc_on=False)
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)
    state, _ = pipe.render_frame(state, pose, 1.0 / 60.0)
    path = str(tmp_path / "ckpt")
    checkpoint.save(state, path)
    restored, resumed = checkpoint.resume_or_init(pipe, path, host)
    assert resumed
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=0)
    # Missing checkpoint -> fresh init.
    _, resumed2 = checkpoint.resume_or_init(pipe, str(tmp_path / "nope"),
                                            host)
    assert not resumed2


def test_preemption_resume_bit_exact(tmp_path):
    """VERDICT r4 item #7: a run killed mid-flight resumes from the last
    periodic checkpoint and reproduces the uninterrupted run bit-exactly
    (the device-lost rebuild analogue, DeviceResources.cpp:552-602).

    Simulates preemption faithfully for state semantics: everything in
    memory is discarded; only the rotating checkpoint dir survives."""
    from drts_tpu.utils import checkpoint
    pipe, host, step = _tiny_default()
    pose = pipe.default_camera_pose(host)
    ckpt_dir = str(tmp_path / "ckpt")

    # Uninterrupted run: 6 frames.
    state = pipe.init_state(host)
    golden = None
    for _ in range(6):
        state, golden = step(state, pose)

    # Preempted run: checkpoint every 2 frames, killed after frame 5
    # (so the last complete checkpoint holds frame 4's state).
    state = pipe.init_state(host)
    for i in range(5):
        state, _ = step(state, pose)
        if (i + 1) % 2 == 0:
            checkpoint.save_rotating(state, ckpt_dir)
    del state  # the preemption: in-memory state is gone

    resumed, ok = checkpoint.resume_or_init(pipe, ckpt_dir, host)
    assert ok
    assert int(resumed.frame_index) == 4
    img = None
    for _ in range(2):  # frames 5 and 6 replayed
        resumed, img = step(resumed, pose)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(golden))


def test_rotating_checkpoint_survives_torn_save(tmp_path):
    """A kill mid-save must leave the previous checkpoint reachable: the
    LATEST marker only moves after a slot write completes, and a slot the
    marker points at that is corrupt falls back to the other slot."""
    import shutil
    from drts_tpu.utils import checkpoint
    pipe, host, step = _tiny_default()
    pose = pipe.default_camera_pose(host)
    ckpt_dir = str(tmp_path / "ckpt")
    state = pipe.init_state(host)
    state, _ = step(state, pose)
    checkpoint.save_rotating(state, ckpt_dir)      # frame 1 -> s0
    state, _ = step(state, pose)
    slot = checkpoint.save_rotating(state, ckpt_dir)  # frame 2 -> s1

    # Torn save: destroy the slot LATEST points at (kill landed between
    # marker update and... any corruption of the newest slot).
    slot_path = os.path.join(ckpt_dir, slot)
    if os.path.isdir(slot_path):
        shutil.rmtree(slot_path)
    else:
        os.remove(slot_path + ".npz")
    restored, ok = checkpoint.resume_or_init(pipe, ckpt_dir, host)
    assert ok
    assert int(restored.frame_index) == 1          # fell back to s0


def test_step_timer():
    from drts_tpu.utils.timer import StepTimer
    calls = []
    t = StepTimer()
    t.tick(lambda dt: calls.append(dt))
    assert len(calls) == 1 and calls[0] >= 0.0
    fixed = StepTimer(fixed_timestep=0.001)
    import time
    time.sleep(0.01)
    fixed.tick(lambda dt: calls.append(dt))
    assert fixed.frame_count >= 5  # caught up in fixed steps


@pytest.mark.skipif(os.environ.get("DRTS_SLOW_TESTS") != "1",
                    reason="driver compile-checks entry(); set "
                           "DRTS_SLOW_TESTS=1 to run locally")
def test_graft_entry_compiles():
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as g
    fn, args = g.entry()
    img = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(img)).all()


def test_debug_views_render():
    """Diagnostic overlays (ReGIR cells / SHARC voxels / NRD validation)
    produce finite, non-degenerate images through the full pipeline."""
    import dataclasses as _dc

    from drts_tpu.models import myscene, pipeline
    from drts_tpu.ops import restir as restir_mod, sharc as sharc_mod

    host = myscene.build(oscillator_grid=2)
    base = pipeline.PipelineConfig(
        output_width=48, output_height=48, render_width=48,
        render_height=48, bounces=2, block_size=2048,
        sharc=sharc_mod.SHARCConfig(capacity_log2=12),
        restir=restir_mod.ReSTIRConfig(regir_cells_per_axis=8,
                                       regir_build_samples=2,
                                       local_light_samples=2))
    for view in ("ReGIRCells", "SHARC", "NRDValidation"):
        pipe = pipeline.RenderPipeline(_dc.replace(base, debug_view=view))
        state = pipe.init_state(host)
        pose = pipe.default_camera_pose(host)
        state, img = pipe.render_frame(state, pose)
        img = np.asarray(img)
        assert np.isfinite(img).all(), view
        assert img.std() > 1e-3, view  # not a flat/black frame


def test_sharc_update_period_skips_frames():
    """sharc_update_period=2 must leave the SHARC cache bit-identical on
    skip frames (the lax.cond gate) while update frames still mutate it
    (Raytracing.ixx:114-148 cadence trade, guarded by ab_frame_cost)."""
    import dataclasses

    pipe0, host = _tiny_pipeline()
    pipe = pipeline.RenderPipeline(
        dataclasses.replace(pipe0.cfg, sharc_update_period=2))
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)
    step = jax.jit(lambda s, p: pipe.render_frame(s, p, 1.0 / 60.0))

    def snap(st):
        return jax.tree.map(np.asarray, (st.sharc.fingerprint,
                                         st.sharc.radiance,
                                         st.sharc.sample_count))

    # frame_index 0: update runs (0 % 2 == 0).
    s0 = snap(state)
    state, _ = step(state, pose)
    s1 = snap(state)
    changed = any((a != b).any() for a, b in zip(s0, s1))
    assert changed, "update frame must mutate the cache"
    # frame_index 1: skip — cache must be bit-identical.
    state2, img = step(state, pose)
    s2 = snap(state2)
    for a, b in zip(s1, s2):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(np.asarray(img)).all()
