#!/usr/bin/env python3
"""Bring-up check: the full frame pipeline on NVIDIA GPUs, in one process.

    python chip_smoke.py                  # every one-card phase
    python chip_smoke.py --only card,kernels
    python chip_smoke.py --four           # 1080p frame sharded over 4 cards

One-card phases:
  card     nvidia-smi name + power limit, device kind, JAX version, XLA_FLAGS
  compile  the jitted frame step at 1920x1080 native and 960x540 -> 1920x1080
           upscaled: compile seconds + memory analysis
  cli      `python -m drts_tpu.app --width 1920 --height 1080 render
           --frames 8` and `... bench --frames 16` (upscaled and native),
           called in-process: frames finite and not black, frame ms
  golden   tests/test_golden.py's recipe on the card vs tests/golden/demo_64.png
  kernels  each kernel of the frame path at real width against its plain
           reference (float64 numpy on a subsample), plus the row-fetch A/B
  mesh     the demo scene as instanced triangle meshes through RenderPipeline
           at 1920x1080 (11 s a frame on an H100)

Each phase prints one line (`phase <name> ok|FAIL ...`) plus its details.
The last line is {"ok": true, "device": {...}} only when every phase
passed; otherwise the script exits non-zero without it. It exits non-zero
at once when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "out", "chip_smoke")
W, H = 1920, 1080
SUBSAMPLE = 4096
# Hit distances before the Newton step in scene.surface_attributes: the f32
# quadratic loses bits to cancellation on the large spheres, so two f32
# orderings of the same formula differ by up to ~1e-4 of max(t, 1).
T_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# shared helpers


def _demo_host():
    from drts_tpu.models import myscene
    return myscene.build(oscillator_grid=10)


def _timed(fn, *args, iters: int = 5) -> float:
    """Mean ms of fn(*args) over iters calls after one warm call."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def _image_ok(img, what: str) -> str:
    import numpy as np
    img = np.asarray(img)
    if not np.isfinite(img).all():
        raise AssertionError(f"{what}: non-finite pixels")
    if img.mean() < 0.01:
        raise AssertionError(f"{what}: black frame (mean {img.mean()})")
    return f"shape {img.shape} mean {img.mean():.4f}"


def _sphere_rays(scene, cam_pos, cam_fwd, seed: int):
    """2 x 1080p rays against the demo scene: camera primaries plus
    incoherent rays (random origins in the scene's box, random
    directions) — the G-buffer's and the bounces' ray mix."""
    import jax
    import jax.numpy as jnp
    from drts_tpu.ops import camera as camera_mod

    cam = camera_mod.make_camera(cam_pos, cam_fwd, horizontal_fov_deg=90.0,
                                 aspect=W / H)
    ro, rd, _, _ = camera_mod.generate_pinhole_rays(
        cam, camera_mod.pixel_ndc(W, H, jnp.zeros(2)))
    n = W * H
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    small = scene.radius < 100.0
    lo = jnp.min(jnp.where(small[:, None], scene.center, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(small[:, None], scene.center, -jnp.inf), axis=0)
    o2 = lo + (hi - lo) * jax.random.uniform(k1, (n, 3))
    d2 = jax.random.normal(k2, (n, 3))
    d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
    o = jnp.concatenate([jnp.broadcast_to(ro, (H, W, 3)).reshape(n, 3), o2])
    d = jnp.concatenate([rd.reshape(n, 3), d2])
    return o.astype(jnp.float32), d.astype(jnp.float32)


def _np_roots(o, d, tmin, tmax, c, r):
    """float64 (n, K) hit distances (inf = none) and the grazing mask: a
    tangent ray (tiny discriminant), a near tie between two spheres, or a
    root at the ends of [tmin, tmax] may fall either way in f32."""
    import numpy as np
    o, d, c, r = (np.asarray(x, np.float64) for x in (o, d, c, r))
    tmin = np.asarray(tmin, np.float64)[:, None]
    tmax = np.asarray(tmax, np.float64)[:, None]
    oc = o[:, None, :] - c[None]
    b = np.einsum("nkc,nc->nk", oc, d)
    c0 = np.einsum("nkc,nkc->nk", oc, oc) - r[None] ** 2
    disc = b * b - c0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0, t1 = -b - sq, -b + sq
    t = np.where(t0 >= tmin, t0, t1)
    t = np.where((disc > 0) & (t >= tmin) & (t <= tmax), t, np.inf)
    scale = b * b + np.abs(c0) + 1.0
    tangent = np.abs(disc) <= 1e-4 * scale
    srt = np.sort(t, axis=1)
    with np.errstate(invalid="ignore"):
        tie = np.isfinite(srt[:, 1]) & (srt[:, 1] - srt[:, 0]
                                        <= 1e-4 * np.abs(srt[:, 0]) + 1e-4)
    ends = ((np.abs(t0 - tmin) <= 1e-4 * np.abs(t0) + 1e-4)
            | (np.abs(t0 - tmax) <= 1e-4 * np.abs(t0) + 1e-4)
            | (np.abs(t1 - tmin) <= 1e-4 * np.abs(t1) + 1e-4)
            | (np.abs(t1 - tmax) <= 1e-4 * np.abs(t1) + 1e-4))
    graze = (tangent | (ends & (disc > 0))).any(axis=1) | tie
    return t, graze


# ---------------------------------------------------------------------------
# phases


def phase_card(ctx):
    import jax
    from drts_tpu.utils import device

    info = device.require_gpu()
    ctx["device"] = info
    log(f"  card: {info['card']}")
    log(f"  jax {jax.__version__}; device_kind {info['kind']}; "
        f"{info['count']} device(s); XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")


def _sessions():
    """(name, settings) of the two full-size configurations."""
    from drts_tpu import config as config_mod, session as session_mod

    upscaled = config_mod.GraphicsSettings().check()
    native = session_mod.set_by_path(upscaled, "post.upscaler", "None")
    return (("native", native), ("upscaled", upscaled))


def phase_compile(ctx):
    from drts_tpu import session as session_mod

    host = _demo_host()
    for name, settings in _sessions():
        sess = session_mod.Session(settings, output_width=W,
                                   output_height=H, host=host)
        cfg = sess.pipe.cfg
        t0 = time.perf_counter()
        compiled = sess.jitted_step().lower(*sess.step_args()).compile()
        secs = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        log(f"  {name} {cfg.render_width}x{cfg.render_height}->"
            f"{cfg.output_width}x{cfg.output_height}: compile {secs:.1f} s")
        log(f"  {name} memory_analysis: {mem}")
        del compiled, sess


def phase_cli(ctx):
    from drts_tpu import app

    os.makedirs(OUT, exist_ok=True)
    size = ["--width", str(W), "--height", str(H)]
    img = app.main(size + ["render", "--frames", "8", "--out-dir", OUT])
    log(f"  render --frames 8 (upscaled): {_image_ok(img, 'render')}")
    settings = os.path.join(OUT, "native.json")
    app.main(["--settings", settings, "set", "post.upscaler=None"])
    for name, extra in (("upscaled", []), ("native", ["--settings",
                                                     settings])):
        rec = app.main(extra + size + ["bench", "--frames", "16"])
        if not rec["image_finite"] or rec["image_mean"] < 0.01:
            raise AssertionError(f"bench {name}: bad frame {rec}")
        log(f"  bench {name} {rec['resolution']}: {rec['frame_ms']:.2f} "
            f"ms/frame on {ctx['device']['card']}; textures_loaded "
            f"{rec['textures_loaded']}")


def phase_golden(ctx):
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_golden
    from drts_tpu.utils import image as image_mod

    img = test_golden.render_golden_frame()
    golden = image_mod.load_image(test_golden.GOLDEN)[..., :3]
    score = image_mod.ssim(img, golden)
    diff = abs(float(img.mean()) - float(golden.mean()))
    log(f"  golden demo_64: SSIM {score:.5f} (> 0.97), mean diff "
        f"{diff:.5f} (< 0.01)")
    if not (score > 0.97 and diff < 0.01 and np.isfinite(img).all()):
        raise AssertionError("golden frame out of bounds")


def _check(name, ok, detail):
    log(f"  {'ok  ' if ok else 'FAIL'} {name}: {detail}")
    return ok


def phase_kernels(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from drts_tpu.models import scene as scene_mod
    from drts_tpu.ops import intersect, light as light_mod, post, reproject
    from drts_tpu.ops import sphere_kernel

    host = _demo_host()
    scene = host.scene
    c, r = scene.center, scene.radius
    o, d = _sphere_rays(scene, host.camera_position, host.camera_forward, 0)
    n = o.shape[0]
    rng = np.random.default_rng(0)
    tmin = jnp.zeros((n,), jnp.float32)
    tmax = jnp.full((n,), jnp.inf, jnp.float32)
    tmax_any = jnp.asarray(rng.uniform(0.0, 60.0, n), jnp.float32)
    excl = jnp.asarray(rng.integers(-1, c.shape[0], n), jnp.int32)
    no_excl = jnp.full((n,), -1, jnp.int32)
    sub = rng.choice(n, SUBSAMPLE, replace=False)
    ok = True

    # Sphere closest hit: Triton kernel vs the XLA path, both vs float64.
    xla_closest = jax.jit(lambda *a: intersect._blocked(
        intersect._block_intersect, 32768, a, c, r))
    xla_any = jax.jit(lambda *a: intersect._blocked(
        intersect._block_occluded, 32768, a, c, r))
    t_k, i_k = sphere_kernel.closest_hit(o, d, tmin, tmax, c, r)
    t_x, i_x = xla_closest(o, d, tmin, tmax)
    t_k, i_k, t_x, i_x = map(np.asarray, (t_k, i_k, t_x, i_x))
    t_ref, graze = _np_roots(np.asarray(o)[sub], np.asarray(d)[sub],
                             np.zeros(SUBSAMPLE), np.full(SUBSAMPLE, np.inf),
                             c, r)
    ref_i = np.where(np.isfinite(t_ref.min(1)), t_ref.argmin(1), 0)
    ref_t = t_ref.min(1)
    keep = ~graze
    for name, (tt, ii) in (("triton", (t_k, i_k)), ("xla", (t_x, i_x))):
        ts, is_ = tt[sub][keep], ii[sub][keep]
        hit = np.isfinite(ref_t[keep])
        idx_ok = np.array_equal(is_, ref_i[keep]) and np.array_equal(
            np.isfinite(ts), hit)
        rel = (np.max(np.abs(ts[hit] - ref_t[keep][hit])
                      / np.maximum(ref_t[keep][hit], 1.0))
               if hit.any() else 0.0)
        ok &= _check(f"sphere closest {name} vs float64",
                     idx_ok and rel <= T_TOL,
                     f"{keep.sum()} non-grazing of {SUBSAMPLE} rays, "
                     f"{hit.sum()} hits, index+hit agree {idx_ok}, max t "
                     f"err / max(t, 1) {rel:.2e} (tol {T_TOL})")
    # Full width: kernel vs XLA on all rays both paths call non-grazing.
    same = (np.isfinite(t_k) == np.isfinite(t_x)) & (i_k == i_x)
    both = np.isfinite(t_k) & np.isfinite(t_x) & same
    rel_full = float(np.max(np.abs(t_k[both] - t_x[both])
                            / np.maximum(t_x[both], 1.0)))
    disagree = int((~same).sum())
    # A disagreement must be a grazing ray (tie / tangent) by float64.
    bad = np.flatnonzero(~same)
    if bad.size:
        pick = bad[:SUBSAMPLE]
        _, g = _np_roots(np.asarray(o)[pick], np.asarray(d)[pick],
                         np.zeros(pick.size), np.full(pick.size, np.inf),
                         c, r)
        bad_real = int((~g).sum())
    else:
        bad_real = 0
    ok &= _check(f"sphere closest triton vs xla, {n} rays",
                 bad_real == 0 and rel_full <= T_TOL,
                 f"{disagree} index/hit disagreements, {bad_real} of them "
                 f"non-grazing; max t diff / max(t, 1) {rel_full:.2e} "
                 f"(tol {T_TOL})")

    # Any hit, with and without exclude_index.
    for label, ex in (("exclude", excl), ("no exclude", no_excl)):
        occ_k = np.asarray(sphere_kernel.any_hit(o, d, tmin, tmax_any, c, r,
                                                 ex))
        occ_x = np.asarray(xla_any(o, d, tmin, tmax_any, ex))
        t_ref_a, graze_a = _np_roots(
            np.asarray(o)[sub], np.asarray(d)[sub], np.zeros(SUBSAMPLE),
            np.asarray(tmax_any)[sub], c, r)
        exs = np.asarray(ex)[sub]
        mask = np.arange(c.shape[0])[None] != exs[:, None]
        ref_occ = (np.isfinite(t_ref_a) & mask).any(1)
        keep_a = ~graze_a
        for name, occ in (("triton", occ_k), ("xla", occ_x)):
            good = np.array_equal(occ[sub][keep_a], ref_occ[keep_a])
            ok &= _check(f"sphere any-hit {label} {name} vs float64", good,
                         f"{keep_a.sum()} non-grazing rays, "
                         f"{ref_occ[keep_a].sum()} occluded")
        diff = np.flatnonzero(occ_k != occ_x)
        bad_real = 0
        if diff.size:
            pick = diff[:SUBSAMPLE]
            _, g = _np_roots(np.asarray(o)[pick], np.asarray(d)[pick],
                             np.zeros(pick.size),
                             np.asarray(tmax_any)[pick], c, r)
            bad_real = int((~g).sum())
        ok &= _check(f"sphere any-hit {label} triton vs xla, {n} rays",
                     bad_real == 0,
                     f"{diff.size} disagreements, {bad_real} non-grazing")

    # Timing of the two sphere paths at full width (same call, same card).
    kc = jax.jit(lambda *a: sphere_kernel.closest_hit(*a, c, r))
    ka = jax.jit(lambda *a: sphere_kernel.any_hit(*a, c, r, excl))
    ms = {
        "closest triton": _timed(kc, o, d, tmin, tmax),
        "closest xla": _timed(xla_closest, o, d, tmin, tmax),
        "any triton": _timed(ka, o, d, tmin, tmax_any),
        "any xla": _timed(xla_any, o, d, tmin, tmax_any, excl),
    }
    log(f"  sphere kernels, {n} rays x {c.shape[0]} spheres (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f" on {ctx['device']['card']}")

    # Row fetch: table[idx] at frame width vs numpy, and the A/B against
    # the one-hot product form the earlier accelerator used.
    table = scene_mod.object_table(scene)
    lights = light_mod.prepare(scene)
    for label, tbl in ((f"object {tuple(table.shape)}", table),
                       (f"compact light {tuple(lights.compact.shape)}",
                        lights.compact)):
        idx = jnp.asarray(rng.integers(0, tbl.shape[0], (H, W)), jnp.int32)
        gather = jax.jit(lambda t, i: t[i])

        def onehot(t, i):
            oh = (i.reshape(-1)[:, None]
                  == jnp.arange(t.shape[0], dtype=i.dtype)[None, :])
            out = jax.lax.dot_general(oh.astype(jnp.float32), t,
                                      (((1,), (0,)), ((), ())),
                                      precision=jax.lax.Precision.HIGHEST)
            return out.reshape(i.shape + (t.shape[1],))

        onehot = jax.jit(onehot)
        got = np.asarray(gather(tbl, idx))
        exact = np.array_equal(got, np.asarray(tbl)[np.asarray(idx)])
        ok &= _check(f"row fetch {label} vs numpy, {H}x{W} lanes", exact,
                     "bit-exact")
        t_g = _timed(gather, tbl, idx)
        t_o = _timed(onehot, tbl, idx)
        log(f"  row fetch A/B {label}: gather {t_g:.3f} ms, one-hot "
            f"product {t_o:.3f} ms on {ctx['device']['card']}")

    # Reprojection gathers at 1080p under smooth + discontinuous motion.
    src = jnp.asarray(rng.standard_normal((H, W, 4)), jnp.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    motion = np.stack([3.3 * np.sin(yy / 97.0) - 1.7,
                       2.1 * np.cos(xx / 53.0) + 0.4], -1)
    motion[:, W // 2:] += np.array([-9.25, 4.5])   # a moving object edge
    motion = jnp.asarray(motion, jnp.float32)
    ps = rng.choice(H * W, SUBSAMPLE, replace=False)
    py, px = ps // W, ps % W
    # Source positions as the code forms them (f32 pixel + f32 motion);
    # the interpolation itself is the float64 reference.
    mx = (np.asarray(motion)[py, px, 0] + px.astype(np.float32)).astype(
        np.float64)
    my = (np.asarray(motion)[py, px, 1] + py.astype(np.float32)).astype(
        np.float64)
    s64 = np.asarray(src, np.float64)
    inb_ref = (mx >= 0) & (mx <= W - 1) & (my >= 0) & (my <= H - 1)
    for filt in ("nearest", "bilinear"):
        prev, inb = jax.jit(reproject.reproject, static_argnums=2)(
            src, motion, filt)
        prev = np.asarray(prev).reshape(-1, 4)[ps]
        inb = np.asarray(inb).reshape(-1)[ps]
        if filt == "nearest":
            ref = s64[np.clip(np.round(my), 0, H - 1).astype(int),
                      np.clip(np.round(mx), 0, W - 1).astype(int)]
            good = np.array_equal(prev, ref.astype(np.float32))
            detail = "bit-exact rows"
        else:
            y0 = np.floor(my)
            x0 = np.floor(mx)
            fy, fx = (my - y0)[:, None], (mx - x0)[:, None]
            y0i = np.clip(y0, 0, H - 1).astype(int)
            x0i = np.clip(x0, 0, W - 1).astype(int)
            y1i, x1i = np.minimum(y0i + 1, H - 1), np.minimum(x0i + 1, W - 1)
            ref = ((s64[y0i, x0i] * (1 - fx) + s64[y0i, x1i] * fx) * (1 - fy)
                   + (s64[y1i, x0i] * (1 - fx) + s64[y1i, x1i] * fx) * fy)
            err = float(np.max(np.abs(prev - ref)))
            good = err <= 1e-5
            detail = f"max abs err {err:.2e} (tol 1e-5, f32 weights)"
        good &= np.array_equal(inb, inb_ref)
        ok &= _check(f"reproject {filt} 1080p vs float64", good,
                     detail + f"; in-bounds flags exact ({inb_ref.sum()} of "
                     f"{SUBSAMPLE} in bounds)")

    # TF32: the HDR10 color rotation is a float32 einsum at HIGHEST; the
    # same code on the CPU backend is the reference.
    img = rng.uniform(0.0, 4.0, (H, W, 3)).astype(np.float32)
    got = np.asarray(jax.jit(post.tonemap_hdr10)(img)).reshape(-1, 3)[ps]
    with jax.default_device(jax.devices("cpu")[0]):
        ref = np.asarray(post.tonemap_hdr10(img.reshape(-1, 3)[ps]))
    err = float(np.max(np.abs(got - ref)))
    ok &= _check("HDR10 rotation einsum vs CPU float32", err <= 1e-4,
                 f"max abs err {err:.2e} (tol 1e-4: the PQ curve's pow "
                 f"differs by ulps between backends; TF32 gives ~1e-3)")
    if not ok:
        raise AssertionError("a kernel comparison failed")


def phase_mesh(ctx):
    import jax
    from drts_tpu.models import myscene, pipeline

    w, h = W, H
    host = myscene.as_mesh_scene(_demo_host(), tessellation=4)
    cfg = pipeline.PipelineConfig(output_width=w, output_height=h,
                                  render_width=w, render_height=h,
                                  physics_enabled=False)
    pipe = pipeline.RenderPipeline(cfg)
    state = pipe.init_state(host)
    pose = pipe.default_camera_pose(host)
    step = jax.jit(lambda s, p: pipe.render_frame(s, p, 1.0 / 60.0))
    t0 = time.perf_counter()
    state, img = step(state, pose)
    jax.block_until_ready(img)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, img = step(state, pose)
    jax.block_until_ready(img)
    ms = (time.perf_counter() - t0) * 1e3
    log(f"  mesh scene ({host.scene.mesh_instances.center.shape[0]} "
        f"geosphere instances, tessellation 4, "
        f"{host.scene.mesh.faces.shape[0]} faces) at {w}x{h}: first call "
        f"{first:.1f} s (compile included), frame {ms:.1f} ms on "
        f"{ctx['device']['card']}; {_image_ok(img, 'mesh')}")


PHASES = {"card": phase_card, "compile": phase_compile, "cli": phase_cli,
          "golden": phase_golden, "kernels": phase_kernels,
          "mesh": phase_mesh}


# ---------------------------------------------------------------------------
# four cards


def run_four(ctx):
    """The native 1080p frame with its buffers row-sharded over 4 cards,
    against the same frame on one card, from the same state."""
    import jax
    import numpy as np
    from drts_tpu import session as session_mod
    from drts_tpu.parallel import mesh as mesh_mod
    from drts_tpu.utils import image as image_mod

    if ctx["device"]["count"] != 4:
        raise AssertionError(f"--four needs 4 GPUs, found "
                             f"{ctx['device']['count']}")
    name, settings = _sessions()[0]
    sess = session_mod.Session(settings, output_width=W, output_height=H,
                               host=_demo_host())
    pipe, pose = sess.pipe, sess.default_pose()
    frames = 3

    def frame(s, p):
        return pipe.render_frame(s, p, 1.0 / 60.0)

    dev0 = jax.devices()[0]
    state1 = jax.device_put(sess.state, dev0)
    pose1 = jax.device_put(pose, dev0)
    mesh = mesh_mod.make_mesh(4)
    cap = (int(sess.state.sharc.fingerprint.shape[0]),)
    shard = mesh_mod.frame_state_sharding(
        sess.state, mesh, image_heights=(pipe.cfg.render_height,
                                         pipe.cfg.output_height),
        slot_table_sizes=cap)
    pose_sh = jax.tree.map(lambda _: mesh_mod.replicated(mesh), pose)
    state4 = jax.device_put(sess.state, shard)
    pose4 = jax.device_put(pose, pose_sh)

    # The two programs compile side by side (XLA releases the GIL).
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        single = pool.submit(
            lambda: jax.jit(frame).lower(state1, pose1).compile())
        sharded = pool.submit(lambda: jax.jit(
            frame, in_shardings=(shard, pose_sh),
            out_shardings=(shard, mesh_mod.image_sharding(mesh))).lower(
                state4, pose4).compile())
        single, sharded = single.result(), sharded.result()
    log(f"  compile (single and sharded, in parallel): "
        f"{time.perf_counter() - t0:.1f} s")

    def run(step, state, p):
        images = []
        for _ in range(frames):
            state, img = step(state, p)
            images.append(img)
        jax.block_until_ready(images)
        return state, images

    _, ref = run(single, state1, pose1)
    ref = [np.asarray(x) for x in ref]
    out_state, got = run(sharded, state4, pose4)
    t_single = _timed(lambda s: single(s, pose1)[1], state1, iters=8)
    t_sharded = _timed(lambda s: sharded(s, pose4)[1], state4, iters=8)

    # Frame buffers must be split: device 0 holds its quarter of the rows,
    # never the whole array.
    whole = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            (out_state, got[-1])):
        if not hasattr(leaf, "sharding"):
            continue
        if leaf.ndim >= 1 and leaf.shape[0] in (H, *cap):
            s0 = [s for s in leaf.addressable_shards if s.device == dev0]
            if len(leaf.sharding.device_set) != 4 or \
                    s0[0].data.shape[0] * 4 != leaf.shape[0]:
                whole.append(jax.tree_util.keystr(path))
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) / 2**30
             for d in jax.devices()]
    log(f"  peak GiB per card: {', '.join(f'{p:.2f}' for p in peaks)}")
    scores = [image_mod.ssim(np.asarray(g), r) for g, r in zip(got, ref)]
    diffs = [float(np.mean(np.abs(np.asarray(g) - r)))
             for g, r in zip(got, ref)]
    log(f"  {name} {W}x{H}, {frames} frames: sharded vs single SSIM "
        f"{', '.join(f'{s:.5f}' for s in scores)} (> 0.99), mean abs diff "
        f"{', '.join(f'{x:.2e}' for x in diffs)} (< 5e-3; scatter-add "
        f"order and reduction order differ across cards)")
    log(f"  frame ms: single card {t_single:.2f}, 4 cards {t_sharded:.2f} "
        f"on {ctx['device']['card']!r}")
    if whole:
        raise AssertionError(f"arrays not split over the 4 cards: {whole}")
    if not all(np.isfinite(np.asarray(g)).all() for g in got):
        raise AssertionError("non-finite sharded frame")
    if min(scores) <= 0.99 or max(diffs) >= 5e-3:
        raise AssertionError("sharded frame differs from the single card")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="only the 4-card sharded frame vs one card")
    p.add_argument("--only", default=",".join(PHASES),
                   help="comma-separated one-card phases to run")
    args = p.parse_args(argv)

    try:
        from drts_tpu.utils import cache
    except ImportError as e:
        log(f"FAIL: the drts_tpu package is not beside this script ({e})")
        return 2
    cache.enable_compile_cache()
    ctx = {}
    phases = ["card", "four"] if args.four else \
        ["card"] + [n for n in args.only.split(",") if n != "card"]
    failed = []
    for name in phases:
        fn = run_four if name == "four" else PHASES[name]
        t0 = time.perf_counter()
        log(f"phase {name} ...")
        try:
            fn(ctx)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            log(f"phase {name} FAIL ({time.perf_counter() - t0:.1f} s)")
            failed.append(name)
            if name == "card":
                break
            continue
        log(f"phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    if failed:
        log(f"FAILED phases: {', '.join(failed)}")
        return 1
    dev = ctx["device"]
    log(dev["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
