"""Benchmark harness: Mray/s and frame ms at 1080p, 1 spp, on one GPU.

Headline: the flagship path tracer at the reference's default workload
(8 bounces, Russian roulette on, the 448-sphere demo scene —
MyAppData.h:183-188 / MyScene.ixx). Also profiles the FULL frame graph
(ReSTIR + SHARC + denoise + TAA + post) per pass and end-to-end, the way
the reference's PIX scoped events attribute frame time (App.cpp:598).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...},
   "full_pipeline_ms": N, "passes_ms": {...}, ...}
and exits non-zero when any cell raised or JAX found no GPU.

Env:
  DRTS_BENCH_FAST=1  -> skip the full-pipeline profile (trace-only).
"""

from __future__ import annotations

import json
import os
import sys
import time


def bench_trace(width=1920, height=1080, bounces=8, spp=1, iters=8):
    """Headline trace throughput: G-buffer + wavefront trace at the
    reference workload, compact_from=2."""
    import jax

    from drts_tpu.models import myscene
    from drts_tpu.ops import camera as camera_mod, gbuffer, pathtrace

    # Textured by default: the reference always pays the texture-gather
    # cost (MyScene.ixx:161-165), so the published number must too.
    host = myscene.build(oscillator_grid=10, load_textures=True)
    scene = host.scene
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 horizontal_fov_deg=90.0,
                                 aspect=width / height)
    cfg = pathtrace.PathTraceConfig(
        width=width, height=height, bounces=bounces, samples_per_pixel=spp,
        russian_roulette=True, block_size=32768, compact_from=2)

    @jax.jit
    def frame(scene, cam, frame_index):
        gbuf = gbuffer.generate(scene, cam, width, height, cfg.block_size)
        out = pathtrace.trace_image(scene, cam, cfg, frame_index, gbuf=gbuf)
        return out.radiance, out.rays_traced

    radiance, rays = frame(scene, cam, 0)  # compile + warm
    jax.block_until_ready(radiance)
    rays_per_frame = float(rays)
    start = time.perf_counter()
    for i in range(iters):
        radiance, rays = frame(scene, cam, i + 1)
    jax.block_until_ready(radiance)
    elapsed = time.perf_counter() - start
    return (rays_per_frame * iters / elapsed / 1e6,
            elapsed / iters * 1e3, rays_per_frame)


def bench_full_pipeline(width=1920, height=1080, iters=4,
                        compact_from=2):
    """Full frame graph at the reference defaults: per-pass ms (separately
    jitted, synced) + monolithic jitted frame ms."""
    import jax

    from drts_tpu.models import myscene, pipeline

    cfg = pipeline.PipelineConfig(
        output_width=width, output_height=height,
        render_width=width, render_height=height,
        bounces=8, samples_per_pixel=1, block_size=32768,
        compact_from=compact_from)
    pipe = pipeline.RenderPipeline(cfg)
    host = myscene.build(oscillator_grid=10, load_textures=True)
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)

    # Warm the temporal state one step so the profile reflects steady state.
    step = jax.jit(lambda s, p: pipe.render_frame(s, p, 1.0 / 60.0))
    state, image = step(state, pose)
    jax.block_until_ready(image)

    # Monolithic frame time FIRST (the headline); per-pass attribution
    # second, and a profiling failure must not lose the frame time.
    start = time.perf_counter()
    cur = state
    for _ in range(iters):
        cur, image = step(cur, pose)
    jax.block_until_ready(image)
    full_ms = (time.perf_counter() - start) / iters * 1e3

    # Loss/cache counters (SURVEY §5.5): wavefront overflow, SHARC splat
    # drops, and per-bounce cache hit rates from the steady-state frame.
    counters = {k: float(v) for k, v in cur.counters.items()}
    hit_rates, gate_rates, entry_rates = {}, {}, {}
    for k in list(counters):
        if k.startswith("sharc_hits_b"):
            b = k[len("sharc_hits_b"):]
            q = counters.get(f"sharc_queries_b{b}", 0.0)
            if q > 0:
                hit_rates[f"b{b}"] = round(counters[k] / q, 3)
                gate_rates[f"b{b}"] = round(
                    counters.get(f"sharc_gate_b{b}", 0.0) / q, 3)
                entry_rates[f"b{b}"] = round(
                    counters.get(f"sharc_entry_b{b}", 0.0) / q, 3)
    report = {k: round(v, 1) for k, v in counters.items()
              if not k.startswith(("sharc_hits", "sharc_queries",
                                   "sharc_gate", "sharc_entry"))}
    if hit_rates:
        report["sharc_hit_rate"] = hit_rates
        # Failure split: gate = footprint heuristic pass rate; entry =
        # resolved-cache-row-exists rate (VERDICT r3 #1 diagnosis).
        report["sharc_gate_rate"] = gate_rates
        report["sharc_entry_rate"] = entry_rates

    passes = pipe.profile_passes(state, pose, iters=iters)
    return full_ms, {k: round(v, 2) for k, v in passes.items()}, report


def bench_mesh(width=1920, height=1080, tess=4, bounces=2, iters=4,
               compact_from=2):
    """General-geometry capability number: the same 448-instance demo
    scene rendered as triangle meshes through the XLA instance sweep
    (ops/trimesh.py) — the reference's geosphere BLAS workload
    (Scene.ixx:225-284)."""
    import jax
    import numpy as np

    from drts_tpu.models import myscene
    from drts_tpu.ops import camera as camera_mod, pathtrace

    host = myscene.build(oscillator_grid=10)
    mh = myscene.as_mesh_scene(host, tessellation=tess)
    cam = camera_mod.make_camera(mh.camera_position, mh.camera_forward,
                                 horizontal_fov_deg=90.0,
                                 aspect=width / height)
    cfg = pathtrace.PathTraceConfig(width=width, height=height,
                                    bounces=bounces, samples_per_pixel=1,
                                    block_size=32768,
                                    compact_from=compact_from)

    @jax.jit
    def frame(scene, cam, fi):
        out = pathtrace.trace_image(scene, cam, cfg, fi)
        return out.radiance, out.rays_traced

    rad, rays = frame(mh.scene, cam, 0)
    jax.block_until_ready(rad)
    assert np.isfinite(np.asarray(rad)).all()
    start = time.perf_counter()
    for i in range(iters):
        rad, rays = frame(mh.scene, cam, i + 1)
    jax.block_until_ready(rad)
    ms = (time.perf_counter() - start) / iters * 1e3
    return float(rays) / 1e6 / (ms / 1e3), ms


def bench_upscaled(width=1920, height=1080, iters=4, compact_from=2):
    """The reference's ACTUAL default config: DLSS-SR 'Auto' at 1080p
    renders at 1/2 scale and upscales (App.cpp:1374-1451, scale table
    ops/taa.py). The render==output record above is the harder workload;
    this one is the apples-to-apples frame time."""
    import jax

    from drts_tpu.models import myscene, pipeline

    cfg = pipeline.PipelineConfig(
        output_width=width, output_height=height,
        render_width=width // 2, render_height=height // 2,
        bounces=8, samples_per_pixel=1, block_size=32768,
        compact_from=compact_from)
    pipe = pipeline.RenderPipeline(cfg)
    host = myscene.build(oscillator_grid=10, load_textures=True)
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)

    step = jax.jit(lambda s, p: pipe.render_frame(s, p, 1.0 / 60.0))
    state, image = step(state, pose)
    jax.block_until_ready(image)
    start = time.perf_counter()
    cur = state
    for _ in range(iters):
        cur, image = step(cur, pose)
    jax.block_until_ready(image)
    return (time.perf_counter() - start) / iters * 1e3


def bench_mesh_pipeline(width=1920, height=1080, iters=2):
    """Full render graph (ReSTIR + SHARC + denoise + TAA upscale) on the
    ALL-MESH demo scene at the reference's default config (540p -> 1080p
    DLSS-SR-Auto upscale, 8 bounces) — the apples-to-apples frame time for
    the reference's actual geosphere-BLAS workload (round-4 VERDICT #4)."""
    import jax

    from drts_tpu.models import myscene, pipeline

    cfg = pipeline.PipelineConfig(
        output_width=width, output_height=height,
        render_width=width // 2, render_height=height // 2,
        bounces=8, samples_per_pixel=1, block_size=32768,
        compact_from=1, physics_enabled=False)
    pipe = pipeline.RenderPipeline(cfg)
    host = myscene.as_mesh_scene(
        myscene.build(oscillator_grid=10, load_textures=True),
        tessellation=4)
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)

    step = jax.jit(lambda s, p: pipe.render_frame(s, p, 1.0 / 60.0))
    state, image = step(state, pose)
    jax.block_until_ready(image)
    start = time.perf_counter()
    cur = state
    for _ in range(iters):
        cur, image = step(cur, pose)
    jax.block_until_ready(image)
    return (time.perf_counter() - start) / iters * 1e3


def main():
    import traceback

    import jax

    from drts_tpu.utils import cache, device

    cache.enable_compile_cache()

    def note(msg):
        print(msg, file=sys.stderr, flush=True)

    record = {
        "metric": "path_trace_1080p_1spp_8bounce",
        "value": 0.0,
        "unit": "Mray/s",
        "device": device.describe(),
    }
    note(f"bench: device {record['device']}")
    errors = []
    if record["device"]["platform"] != "gpu":
        errors.append("no GPU: JAX's default device is "
                      f"{record['device']['platform']}")

    def cell(name, fn):
        if errors:
            return
        try:
            note(f"bench: {name}...")
            fn()
        except Exception:
            errors.append(f"{name}: " + traceback.format_exc(limit=2))

    def trace():
        mray_s, frame_ms, rays_per_frame = bench_trace()
        record.update(value=mray_s, frame_ms=frame_ms,
                      rays_per_frame=int(rays_per_frame))
        note(f"bench: trace {mray_s:.1f} Mray/s ({frame_ms:.1f} ms)")

    def full():
        full_ms, passes, counters = bench_full_pipeline()
        record["full_pipeline_ms"] = full_ms
        record["passes_ms"] = passes
        record["counters"] = counters
        record["passes_sum_ms"] = sum(passes.values())
        note(f"bench: full pipeline {full_ms:.1f} ms")

    def upscaled():
        record["full_pipeline_upscaled_ms"] = bench_upscaled()

    def mesh():
        record["mesh_trace_mray_s"], record["mesh_trace_ms"] = bench_mesh()

    def mesh8():
        (record["mesh_trace_8b_mray_s"],
         record["mesh_trace_8b_ms"]) = bench_mesh(bounces=8, iters=2)

    def mesh_pipeline():
        record["mesh_pipeline_upscaled_ms"] = bench_mesh_pipeline()

    # Headline first, so a later failure cannot lose it.
    cell("trace", trace)
    if not os.environ.get("DRTS_BENCH_FAST"):
        cell("full_pipeline", full)
        cell("upscaled", upscaled)
        cell("mesh", mesh)
        cell("mesh8", mesh8)
        cell("mesh_pipeline", mesh_pipeline)

    if errors:
        record["errors"] = errors
    print(json.dumps(record), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
