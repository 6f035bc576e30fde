"""Application shell: CLI entry replacing the Win32/ImGui loop.

Replacement for the reference's Source/Main.cpp (wWinMain +
message pump) and the interactive parts of Source/App.cpp: subcommands

  render       — render N frames of the demo scene to PNG
  bench        — frame-time / Mray/s loop (StepTimer FPS analogue)
  interactive  — scripted camera fly-through (the fly-cam analogue)

Settings load/save uses the JSON config system (config.py), mirroring
MyAppData's Settings/ directory convention.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _load_settings(args):
    from . import config as config_mod

    if args.settings and os.path.exists(args.settings):
        return config_mod.load_settings(args.settings)
    return config_mod.GraphicsSettings().check()


def _build_session(args):
    from . import session as session_mod
    from .models import myscene

    settings = _load_settings(args)
    overrides = {}
    if args.bounces is not None:
        overrides["bounces"] = args.bounces
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.no_denoise:
        overrides["denoiser"] = "None"
    if args.no_physics:
        overrides["physics_enabled"] = False
    if args.debug_view != "None":
        overrides["debug_view"] = args.debug_view

    host = myscene.build(seed=args.seed,
                         load_textures=not args.no_textures)
    return session_mod.Session(settings, output_width=args.width,
                               output_height=args.height, host=host,
                               config_overrides=overrides)


def _parse_mutations(args):
    """--mutate FRAME:key=value entries -> {frame: [(key, value), ...]}."""
    sched: dict = {}
    for entry in getattr(args, "mutate", None) or []:
        at, _, kv = entry.partition(":")
        key, _, value = kv.partition("=")
        sched.setdefault(int(at), []).append((key, value))
    return sched


def _maybe_reload(sess, args, mtime_box):
    """--watch-settings: re-apply the settings file when it changes."""
    if not getattr(args, "watch_settings", False):
        return
    try:
        mtime = os.path.getmtime(args.settings)
    except OSError:
        return
    if mtime_box[0] is None:
        mtime_box[0] = mtime
    elif mtime > mtime_box[0]:
        mtime_box[0] = mtime
        changed = sess.reload_settings(args.settings)
        if changed:
            print(f"settings reloaded: {', '.join(changed)}")


def cmd_render(args):
    from .utils import checkpoint as ckpt_mod
    from .utils import image as image_mod

    sess = _build_session(args)
    if args.resume:
        # Elastic recovery (SURVEY §5.3): resume the temporal state pytree
        # from the checkpoint directory if one exists, else start fresh.
        sess.state, resumed = ckpt_mod.resume_or_init(sess.pipe, args.resume,
                                                      sess.host)
        if resumed:
            print(f"resumed at frame {int(sess.state.frame_index)}")
    pose = sess.default_pose()
    mutations = _parse_mutations(args)
    mtime_box = [None]

    os.makedirs(args.out_dir, exist_ok=True)
    # Structured per-frame metrics (SURVEY §5.1/§5.5: the PIX/PCL/debug-
    # overlay stack collapsed into FrameMetrics + pass_scope annotations).
    from .utils import obs
    metrics = obs.FrameMetrics()
    for i in range(args.frames):
        for key, value in mutations.get(i, ()):
            how = sess.set(key, value)
            print(f"frame {i}: set {key}={value} ({how})")
        _maybe_reload(sess, args, mtime_box)
        with metrics.frame() as rec:
            with obs.pass_scope("frame"):
                img = sess.step(pose)
            rec["frame_index"] = i
        if i >= args.frames - args.save_last:
            path = os.path.join(args.out_dir, f"frame_{i:04d}.png")
            image_mod.write_png(path, np.asarray(img))
            print(f"wrote {path}")
        if (args.resume and args.checkpoint_every
                and (i + 1) % args.checkpoint_every == 0
                and i + 1 < args.frames):
            # Periodic cadence (SURVEY §5.3): a preemption loses at most
            # checkpoint_every frames, not the whole run.
            ckpt_mod.save_rotating(sess.state, args.resume)
            print(f"checkpointed frame {int(sess.state.frame_index)}")
    counters = getattr(sess.state, "counters", None)
    summary = metrics.summary()
    if counters:
        summary.update({k: float(v) for k, v in counters.items()})
    if args.metrics_out:
        metrics.dump(args.metrics_out)
    print("metrics: " + json.dumps(
        {k: round(v, 3) for k, v in sorted(summary.items())}))
    if args.resume:
        ckpt_mod.save_rotating(sess.state, args.resume)
        print(f"checkpointed frame {int(sess.state.frame_index)}")
    return np.asarray(img)


def cmd_bench(args):
    import jax

    sess = _build_session(args)
    pose = sess.default_pose()

    img = sess.step(pose)  # compile
    jax.block_until_ready(img)
    start = time.perf_counter()
    for _ in range(args.frames):
        img = sess.step(pose)
    jax.block_until_ready(img)
    elapsed = time.perf_counter() - start
    cfg = sess.pipe.cfg
    record = {
        "frames": args.frames,
        "frame_ms": elapsed / args.frames * 1e3,
        "fps": args.frames / elapsed,
        "resolution": f"{cfg.render_width}x{cfg.render_height}"
                      f"->{cfg.output_width}x{cfg.output_height}",
        "textures_loaded": sess.host.atlas is not None,
        "device": jax.devices()[0].device_kind,
        "image_finite": bool(np.isfinite(np.asarray(img)).all()),
        "image_mean": float(np.mean(np.asarray(img))),
    }
    counters = getattr(sess.state, "counters", None)
    if counters:
        record["counters"] = {k: round(float(v), 1)
                              for k, v in sorted(counters.items())}
    if args.passes:
        passes = sess.pipe.profile_passes(sess.state, pose)
        record["passes_ms"] = {k: round(v, 2) for k, v in passes.items()}
    print(json.dumps(record))
    return record


def cmd_set(args):
    """Persisted settings mutation: `drts_tpu set key=value [...]` edits the
    settings JSON (the settings-window Save path)."""
    from . import config as config_mod
    from . import session as session_mod

    settings = _load_settings(args)
    for entry in args.assignments:
        key, _, value = entry.partition("=")
        settings = session_mod.set_by_path(settings, key, value)
        print(f"set {key} = {value}")
    os.makedirs(os.path.dirname(args.settings) or ".", exist_ok=True)
    config_mod.save_settings(settings, args.settings)
    print(f"saved {args.settings}")


def _interactive_keys(args, sess, mutations, mtime_box, camera_mod,
                      image_mod):
    """Key-driven fly camera: each tick polls one key (scripted string or
    live TTY), applies it to the CameraController, renders a frame."""
    import time

    import numpy as np

    default = sess.default_pose()

    def make_controller():
        return camera_mod.CameraController(
            position=np.asarray(default.position, np.float64),
            forward=np.asarray(default.forward, np.float64))

    from . import config as config_mod

    controls = config_mod.load_controls(args.controls)
    ctl = make_controller()
    scripted = args.keys is not None
    keys = iter(args.keys) if scripted else _read_keys_live()
    print(camera_mod.KEY_HELP, flush=True)
    prev = ctl.pose()
    os.makedirs(args.out_dir, exist_ok=True)
    shots = 0
    t_last = time.perf_counter()
    img = None
    i = 0
    # Live mode runs until 'x'/Ctrl-C like a real app window — a frame
    # budget would end the session mid-flight (idle ticks still render,
    # accumulating temporal history). Scripted mode ends with its string.
    try:
        while True:
            for key, value in mutations.get(i, ()):
                how = sess.set(key, value)
                print(f"tick {i}: set {key}={value} ({how})", flush=True)
            _maybe_reload(sess, args, mtime_box)
            try:
                k = next(keys)
            except StopIteration:
                break
            now = time.perf_counter()
            dt = 1.0 / 60.0 if scripted else max(now - t_last, 1e-4)
            t_last = now
            # Speed * elapsed, the reference's ProcessInput scaling
            # (Controls.json Camera.Speed, MyAppData.h:392-414). dt is
            # clamped above too: a JIT-compile hitch of tens of seconds
            # must not teleport the camera on the next keypress.
            action = camera_mod.apply_input_key(
                ctl, k,
                move_step=controls.camera_movement_speed
                * min(max(dt, 1e-2), 0.1),
                turn_step=controls.camera_rotation_speed * np.deg2rad(10.0))
            if action == "quit":
                break
            if action == "reset":
                ctl = make_controller()
            pose = ctl.pose()
            img = sess.step(pose, dt=dt, prev_pose=prev)
            prev = pose
            if action == "screenshot":
                path = os.path.join(args.out_dir, f"shot_{shots:04d}.png")
                image_mod.write_png(path, np.asarray(img))
                print(f"wrote {path}", flush=True)
                shots += 1
            if action:
                p = np.asarray(pose.position).round(2)
                print(f"tick {i}: {action} pos={p.tolist()}", flush=True)
            i += 1
    except KeyboardInterrupt:
        print("interrupted", flush=True)
    if img is not None and args.save_last:
        path = os.path.join(args.out_dir, "final.png")
        image_mod.write_png(path, np.asarray(img))
        print(f"wrote {path}", flush=True)


def _read_keys_live():
    """Generator of keypresses from a cbreak TTY (the reference's per-frame
    ProcessInput poll, App.cpp:812-970). Yields '' when no key is pending
    so the render loop keeps ticking."""
    import select
    import sys
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            r, _, _ = select.select([sys.stdin], [], [], 0.0)
            yield sys.stdin.read(1) if r else ""
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def cmd_interactive(args):
    """Fly-camera loop (CameraController analogue): --keys drives it with
    a scripted key string (space = tick with no input), a TTY drives it
    live (WASD..., see camera.KEY_HELP), otherwise a scripted orbit; all
    modes support mid-flight settings mutation."""
    import jax.numpy as jnp
    from .models.pipeline import CameraPose
    from .ops import camera as camera_mod
    from .utils import image as image_mod
    from .utils import timer as timer_mod

    sess = _build_session(args)
    mutations = _parse_mutations(args)
    mtime_box = [None]

    if args.wasd and args.keys is None and not os.isatty(0):
        raise SystemExit("interactive --wasd needs a TTY on stdin "
                         "(use --keys STR for scripted input)")
    if args.keys is not None or args.wasd:
        return _interactive_keys(args, sess, mutations, mtime_box,
                                 camera_mod, image_mod)

    os.makedirs(args.out_dir, exist_ok=True)
    prev = sess.default_pose()

    # The reference's main loop is StepTimer::Tick(Update) (App.cpp Tick):
    # the timer owns elapsed-time clamping and FPS accounting, Update gets
    # the measured dt — here the dt feeds the on-device physics step.
    timer = timer_mod.StepTimer()

    for i in range(args.frames):
        for key, value in mutations.get(i, ()):
            how = sess.set(key, value)
            print(f"frame {i}: set {key}={value} ({how})")
        _maybe_reload(sess, args, mtime_box)
        angle = 2.0 * np.pi * i / max(args.frames, 1) * 0.25
        pos = np.array([15.0 * np.sin(angle), 2.0, -15.0 * np.cos(angle)],
                       np.float32)
        fwd = -pos / np.linalg.norm(pos)
        pose = CameraPose(position=jnp.asarray(pos),
                          forward=jnp.asarray(fwd, jnp.float32),
                          up=jnp.asarray([0.0, 1.0, 0.0], jnp.float32))

        frames_img = []
        timer.tick(lambda dt: frames_img.append(
            sess.step(pose, dt=max(dt, 1e-4), prev_pose=prev)))
        img = frames_img[-1] if frames_img else sess.step(pose,
                                                          prev_pose=prev)
        prev = pose
        if timer.frames_per_second:
            print(f"frame {i}: {timer.frames_per_second:.1f} fps")
            timer.frames_per_second = 0.0
        if args.save_last and i >= args.frames - args.save_last:
            path = os.path.join(args.out_dir, f"orbit_{i:04d}.png")
            image_mod.write_png(path, np.asarray(img))
            print(f"wrote {path}")


def main(argv=None):
    p = argparse.ArgumentParser("drts_tpu",
                                description="JAX real-time path tracer")
    p.add_argument("--settings", default="Settings/graphics.json",
                   help="JSON settings file (MyAppData analogue)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--debug-view", default="None",
                   choices=["None", "ReGIRCells", "SHARC", "NRDValidation"],
                   help="diagnostic overlay (ReGIR cells / SHARC voxels / "
                        "denoiser history validation)")
    p.add_argument("--no-physics", action="store_true")
    p.add_argument("--no-textures", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    def add_runtime_flags(sp):
        sp.add_argument("--mutate", action="append", metavar="FRAME:KEY=VAL",
                        help="apply a settings change at frame N "
                             "(the ImGui settings-window analogue)")
        sp.add_argument("--watch-settings", action="store_true",
                        help="reload the settings file when it changes")

    r = sub.add_parser("render")
    r.add_argument("--frames", type=int, default=8)
    r.add_argument("--save-last", type=int, default=1)
    r.add_argument("--out-dir", default="out")
    r.add_argument("--metrics-out", default=None, metavar="JSONL",
                   help="write per-frame metric records (JSON lines)")
    r.add_argument("--resume", default=None, metavar="CKPT_DIR",
                   help="resume temporal state from / checkpoint to DIR")
    r.add_argument("--checkpoint-every", type=int, default=16,
                   metavar="N", help="with --resume: also checkpoint every "
                   "N frames (preemption loses at most N frames; 0 = only "
                   "at the end)")
    add_runtime_flags(r)
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("bench")
    b.add_argument("--frames", type=int, default=16)
    b.add_argument("--passes", action="store_true",
                   help="also print per-pass ms (separately jitted)")
    b.set_defaults(fn=cmd_bench)

    st = sub.add_parser("set", help="edit the settings JSON: key=value ...")
    st.add_argument("assignments", nargs="+", metavar="KEY=VALUE")
    st.set_defaults(fn=cmd_set)

    it = sub.add_parser("interactive")
    it.add_argument("--frames", type=int, default=32)
    it.add_argument("--save-last", type=int, default=4)
    it.add_argument("--out-dir", default="out")
    it.add_argument("--keys", default=None, metavar="STR",
                    help="scripted key string for the fly camera "
                         "(w/a/s/d/q/e move, i/j/k/l/u/o look, r reset, "
                         "p screenshot, x quit; space = idle tick)")
    it.add_argument("--wasd", action="store_true",
                    help="live keyboard fly camera (requires a TTY)")
    it.add_argument("--controls", default="Settings/controls.json",
                    help="Controls.json (camera speeds, MyAppData.h:392)")
    add_runtime_flags(it)
    it.set_defaults(fn=cmd_interactive)

    args = p.parse_args(argv)
    from .utils import cache
    cache.enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    main()
