"""Fidelity harness: SSIM of the real-time pipeline against a high-spp
accumulated reference render (the BASELINE.md target: SSIM >= 0.98 vs a
1024-spp reference).

The reference render is the framework's own unbiased path tracer run with
camera-jittered accumulation and no denoising/post — the ground truth the
reference's converged DXR output represents. The candidate is the
real-time configuration (1 spp + ReSTIR + SHARC + denoise + TAA), compared
after identical tone mapping.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from .utils import cache as cache_mod

DEFAULT_REF_CACHE = cache_mod.ref_cache_dir()


def _note(msg: str):
    """Progress to stderr: a fidelity run is many minutes of silent device
    work (compiles + converged references); a watcher must be able to
    tell alive from wedged."""
    print(f"fidelity[{time.strftime('%H:%M:%S')}]: {msg}",
          file=sys.stderr, flush=True)


def reference_render(host, width: int, height: int, spp_total: int = 1024,
                     bounces: int = 8, block_size: int = 32768,
                     position=None, forward=None):
    """Accumulated ground-truth render (no denoise, no physics motion)."""
    import jax
    import jax.numpy as jnp
    from .ops import camera as camera_mod, pathtrace
    from .utils import rng as rng_mod

    scene = host.scene
    pos = host.camera_position if position is None else tuple(position)
    fwd = host.camera_forward if forward is None else tuple(forward)
    jitter_table = jnp.asarray(rng_mod.halton_jitter(64))
    cfg = pathtrace.PathTraceConfig(width=width, height=height,
                                    bounces=bounces, samples_per_pixel=1,
                                    block_size=block_size)

    # Accumulate on the device in chunks (no per-frame host pull).
    chunk = 32

    @jax.jit
    def render_chunk(scene, start, acc):
        def body(i, acc):
            fi = start + i
            cam = camera_mod.make_camera(
                pos, fwd, aspect=width / height,
                jitter=jitter_table[jnp.mod(fi, 64)])
            return acc + pathtrace.trace_image(scene, cam, cfg,
                                               fi).radiance
        return jax.lax.fori_loop(0, chunk, body, acc)

    acc = jnp.zeros((height, width, 3), jnp.float32)
    n_chunks = -(-spp_total // chunk)
    for c in range(n_chunks):
        acc = render_chunk(scene, c * chunk, acc)
        if c == 0 or c == n_chunks - 1:
            jax.block_until_ready(acc)
            _note(f"reference chunk {c + 1}/{n_chunks} "
                  f"({(c + 1) * chunk} spp)")
    return (np.asarray(acc, np.float64)
            / (-(-spp_total // chunk) * chunk)).astype(np.float32)


def realtime_render(host, width: int, height: int, frames: int = 64,
                    settle: bool = True,
                    pipeline_overrides: dict | None = None):
    """The full real-time pipeline after temporal history settles
    (static camera). Returns the final display-space frame and the pipeline
    for config introspection."""
    import jax
    from .models import pipeline as pipeline_mod

    # Post effects the ground truth doesn't have (bloom glow, sharpen
    # overshoot) are disabled — the comparison isolates integrator +
    # denoiser + TAA fidelity.
    cfg = pipeline_mod.PipelineConfig(
        output_width=width, output_height=height,
        render_width=width, render_height=height,
        bounces=8, samples_per_pixel=1, upscaling=False,
        physics_enabled=False, block_size=32768,
        bloom_enabled=False, sharpen_enabled=False,
        **(pipeline_overrides or {}))
    pipe = pipeline_mod.RenderPipeline(cfg)
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)
    step = jax.jit(lambda s, p: pipe.render_frame(s, p, 1.0 / 60.0))
    img = None
    for _ in range(frames):
        state, img = step(state, pose)
    return np.asarray(img), pipe


def _orbit_poses(host, n_frames: int, deg_per_frame: float = 0.75,
                 focus_dist: float = 8.0):
    """Camera positions orbiting the demo scene focus point (the moving-
    camera fidelity sequence — VERDICT r1 item 3: temporal accumulation
    must hold up under reprojection, not just a static pose)."""
    pos0 = np.asarray(host.camera_position, np.float64)
    fwd0 = np.asarray(host.camera_forward, np.float64)
    fwd0 = fwd0 / np.linalg.norm(fwd0)
    focus = pos0 + fwd0 * focus_dist
    poses = []
    for i in range(n_frames):
        a = np.deg2rad(deg_per_frame * i)
        rot = np.array([[np.cos(a), 0.0, np.sin(a)],
                        [0.0, 1.0, 0.0],
                        [-np.sin(a), 0.0, np.cos(a)]])
        rel = rot @ (pos0 - focus)
        p = focus + rel
        f = (focus - p)
        f = f / np.linalg.norm(f)
        poses.append((p.astype(np.float32), f.astype(np.float32)))
    return poses


def _cached_reference(cache_dir, key, render):
    """Disk-cached converged reference render: the 256-1024 spp ground
    truths dominate fidelity wall time (~90%) and depend only on
    (scene seed, pose, resolution, spp) — caching them makes denoiser/
    TAA tuning sweeps ~8x faster. Integrator changes that alter ground
    truth need the cache dir cleared (it lives under /tmp, so a fresh
    machine or reboot starts clean)."""
    import os
    if not cache_dir:
        return render()
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        return np.load(path)["ref"]
    ref = render()
    np.savez_compressed(path, ref=ref)
    return ref


def run_motion(width: int = 640, height: int = 360,
               spp_reference: int = 256, n_frames: int = 32,
               warmup: int = 24, seed: int = 0, eval_every: int = 4,
               load_textures: bool = True,
               ref_cache: str | None = DEFAULT_REF_CACHE,
               save_dir: str | None = None,
               pipeline_overrides: dict | None = None) -> dict:
    """Moving-camera fidelity: orbit the camera; SSIM of each evaluated
    frame against a per-pose converged reference. Reports min/mean —
    the static-pose headline lets temporal accumulation do all the work;
    this sequence measures reprojection quality under motion."""
    import jax
    import jax.numpy as jnp
    from .models import myscene, pipeline as pipeline_mod
    from .ops import post
    from .utils import image as image_mod

    host = myscene.build(seed=seed, load_textures=load_textures)
    poses = _orbit_poses(host, n_frames)

    cfg = pipeline_mod.PipelineConfig(
        output_width=width, output_height=height,
        render_width=width, render_height=height,
        bounces=8, samples_per_pixel=1, upscaling=False,
        physics_enabled=False, block_size=32768,
        bloom_enabled=False, sharpen_enabled=False,
        **(pipeline_overrides or {}))
    pipe = pipeline_mod.RenderPipeline(cfg)
    state = pipe.init_state(host)

    def mk_pose(p, f):
        return pipeline_mod.CameraPose(
            position=jnp.asarray(p), forward=jnp.asarray(f),
            up=jnp.asarray((0.0, 1.0, 0.0), jnp.float32))

    step = jax.jit(lambda s, p, pp: pipe.render_frame(s, p, 1.0 / 60.0,
                                                      prev_pose=pp))
    pose0 = mk_pose(*poses[0])
    _note(f"motion: compiling pipeline @{width}x{height} + {warmup} "
          "warmup frames...")
    img = None
    for _ in range(warmup):
        state, img = step(state, pose0, pose0)
    if img is not None:  # warmup=0 must not NameError (ADVICE r3)
        jax.block_until_ready(img)
    _note("motion: warmup done, starting orbit")

    scores = []
    prev = pose0
    for i, (p, f) in enumerate(poses):
        cur = mk_pose(p, f)
        state, img = step(state, cur, prev)
        prev = cur
        if i % eval_every != 0:
            continue
        key = (f"orbit_s{seed}_t{int(load_textures)}_{width}x{height}"
               f"_spp{spp_reference}_f{i}")
        ref_linear = _cached_reference(
            ref_cache, key,
            lambda: reference_render(host, width, height, spp_reference,
                                     position=p, forward=f))
        ref_display = np.asarray(post.tonemap(jnp.asarray(ref_linear)))
        scores.append(float(image_mod.ssim(np.asarray(img), ref_display)))
        _note(f"motion: frame {i}/{n_frames} SSIM {scores[-1]:.4f}")
        if save_dir is not None:
            import os
            os.makedirs(save_dir, exist_ok=True)
            image_mod.write_png(
                os.path.join(save_dir, f"rt_{i:03d}_{scores[-1]:.4f}.png"),
                np.asarray(img))
            image_mod.write_png(
                os.path.join(save_dir, f"ref_{i:03d}.png"), ref_display)

    return {
        "metric": "ssim_motion_orbit",
        "value": round(float(np.mean(scores)), 4),
        "min": round(float(np.min(scores)), 4),
        "per_frame": [round(s, 4) for s in scores],
        "unit": "SSIM",
        "frames": n_frames,
        "evaluated": len(scores),
        "reference_spp": spp_reference,
        "resolution": f"{width}x{height}",
    }


def run_mesh(width: int = 640, height: int = 360,
             spp_reference: int = 256, frames_realtime: int = 64,
             seed: int = 0, tessellation: int = 4,
             load_textures: bool = True,
             ref_cache: str | None = DEFAULT_REF_CACHE,
             save_dir: str | None = None) -> dict:
    """Static fidelity of the MESH-geometry path (VERDICT r4 #5b): the
    demo scene rendered as 448 instanced geosphere BLASes — the
    reference's actual workload (Source/Scene.ixx:225-284) — through the
    full real-time pipeline, scored against its own converged reference.
    Same contract as run(); only the geometry representation differs."""
    from .models import myscene
    from .ops import post
    from .utils import image as image_mod
    import jax.numpy as jnp

    host = myscene.build(seed=seed, load_textures=load_textures)
    mh = myscene.as_mesh_scene(host, tessellation=tessellation)
    key = (f"mesh{tessellation}_s{seed}_t{int(load_textures)}"
           f"_{width}x{height}_spp{spp_reference}")
    ref_linear = _cached_reference(
        ref_cache, key,
        lambda: reference_render(mh, width, height, spp_reference))
    ref_display = np.asarray(post.tonemap(jnp.asarray(ref_linear)))
    _note(f"mesh static: reference ready; rendering {frames_realtime} "
          "real-time frames...")
    rt_display, pipe = realtime_render(mh, width, height, frames_realtime)
    if save_dir:
        import os
        os.makedirs(save_dir, exist_ok=True)
        image_mod.write_png(os.path.join(save_dir, "mesh_reference.png"),
                            ref_display)
        image_mod.write_png(os.path.join(save_dir, "mesh_realtime.png"),
                            rt_display)
    score = image_mod.ssim(rt_display, ref_display)
    return {
        "metric": "ssim_vs_reference_mesh",
        "value": round(float(score), 4),
        "unit": "SSIM",
        "vs_baseline": round(float(score) / 0.98, 4),
        "reference_spp": spp_reference,
        "realtime_frames": frames_realtime,
        "tessellation": tessellation,
        "resolution": f"{width}x{height}",
    }


def run(width: int = 640, height: int = 360, spp_reference: int = 1024,
        frames_realtime: int = 64, seed: int = 0,
        load_textures: bool = True, save_dir: str | None = None,
        ref_cache: str | None = DEFAULT_REF_CACHE,
        crosscheck_spp: int = 0,
        pipeline_overrides: dict | None = None) -> dict:
    """Full fidelity evaluation; returns the metric dict."""
    from .models import myscene
    from .ops import post
    from .utils import image as image_mod
    import jax.numpy as jnp

    host = myscene.build(seed=seed, load_textures=load_textures)
    key = (f"static_s{seed}_t{int(load_textures)}_{width}x{height}"
           f"_spp{spp_reference}")
    ref_linear = _cached_reference(
        ref_cache, key,
        lambda: reference_render(host, width, height, spp_reference))
    ref_display = np.asarray(post.tonemap(jnp.asarray(ref_linear)))
    _note(f"static: reference ready; rendering {frames_realtime} "
          "real-time frames...")
    rt_display, pipe = realtime_render(host, width, height, frames_realtime,
                                       pipeline_overrides=pipeline_overrides)
    if save_dir:
        import os
        os.makedirs(save_dir, exist_ok=True)
        image_mod.write_png(os.path.join(save_dir, "reference.png"),
                            ref_display)
        image_mod.write_png(os.path.join(save_dir, "realtime.png"),
                            rt_display)

    score = image_mod.ssim(rt_display, ref_display)
    result = {
        "metric": "ssim_vs_reference",
        "value": round(float(score), 4),
        "unit": "SSIM",
        "vs_baseline": round(float(score) / 0.98, 4),
        "reference_spp": spp_reference,
        "realtime_frames": frames_realtime,
        "resolution": f"{width}x{height}",
    }
    if crosscheck_spp:
        # De-circularized ground truth (round-4 VERDICT #6): a full-frame
        # render checked against the INDEPENDENT numpy tracer
        # (drts_tpu/crosscheck.py shares no transport code with the JAX
        # integrator), so integrator-wide bias cannot pass silently
        # through the self-referential converged reference above.
        from . import crosscheck
        _note("crosscheck: independent-tracer full-frame comparison...")
        result["crosscheck"] = crosscheck.run(width=160, height=90,
                                              spp=crosscheck_spp)
    return result


def main():
    import argparse

    # Same persistent compile cache as bench.py: the orbit sweep re-jits
    # the identical pipeline program every run.
    cache_mod.enable_compile_cache()

    p = argparse.ArgumentParser("fidelity")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=1024)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--motion", action="store_true",
                   help="moving-camera orbit sequence (min/mean SSIM)")
    p.add_argument("--mesh", action="store_true",
                   help="static fidelity of the instanced-mesh path")
    p.add_argument("--save", default=None,
                   help="directory to dump reference/realtime PNGs")
    p.add_argument("--crosscheck-spp", type=int, default=0,
                   help="also run the independent-tracer full-frame "
                        "crosscheck at 160x90 with this many spp")
    p.add_argument("--record", default=None,
                   help="merge the result into this JSON file keyed by "
                        "metric name")
    args = p.parse_args()
    if args.motion:
        result = run_motion(args.width, args.height,
                            min(args.spp, 256), args.frames,
                            save_dir=args.save)
    elif args.mesh:
        result = run_mesh(args.width, args.height, min(args.spp, 256),
                          args.frames, save_dir=args.save)
    else:
        result = run(args.width, args.height, args.spp, args.frames,
                     save_dir=args.save,
                     crosscheck_spp=args.crosscheck_spp)
    if args.record:
        import os
        rec = {}
        if os.path.exists(args.record):
            with open(args.record) as fh:
                rec = json.load(fh)
        rec[result["metric"]] = result
        with open(args.record, "w") as fh:
            json.dump(rec, fh, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
