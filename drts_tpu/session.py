"""Runtime settings mutation: the ImGui settings-window analogue.

The reference's settings window mutates ~40 GraphicsSettings live
(/root/reference/Source/App.cpp:1875-2273); heavyweight changes are
deferred to frame boundaries as futures (App.cpp:166-175) and most changes
set ``m_resetHistory`` (App.cpp:667-679). Under XLA the same contract
becomes:

* **dynamic scalars** (exposure, bloom strength, sharpness) ride a
  ``DynamicSettings`` pytree argument — a `set` takes effect on the next
  frame with NO recompilation;
* **static (topology) changes** (bounces, denoiser mode, resolution,
  ReSTIR/SHARC parameters) rebuild the ``PipelineConfig`` and drop the
  cached jitted step — the next frame recompiles, temporal state is
  migrated (or reallocated when buffer shapes changed), and history is
  reset, exactly the deferred-futures + reset-history semantics.

``Session`` is what the CLI drives (app.py `--mutate`, `--watch-settings`,
and the `set` subcommand).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Any

import jax
import jax.numpy as jnp

from . import config as config_mod
from .models import myscene, pipeline

# Settings whose value feeds the DynamicSettings pytree — mutate without
# recompiling (the "immediate" ImGui sliders).
DYNAMIC_KEYS = {"post.exposure", "post.bloom_strength", "post.sharpness"}

# Static keys whose change forces a fresh FrameState allocation (buffer
# shapes / capacities change), not just a history reset.
REALLOC_KEYS = {"render_width", "render_height", "sharc.capacity_log2",
                "post.upscaler", "post.super_resolution_mode"}

# Settings keys that CLI config_overrides may pin: a runtime `set` on the
# settings key must release the pin so the change takes effect.
_OVERRIDE_FOR_KEY = {
    "raytracing.bounces": "bounces",
    "raytracing.samples_per_pixel": "samples_per_pixel",
    "post.denoiser": "denoiser",
}


def _parse_value(current: Any, text: Any) -> Any:
    """Coerce a CLI string to the type of the current settings field."""
    if not isinstance(text, str):
        return text
    if isinstance(current, enum.Enum):
        return type(current)(text)
    if isinstance(current, bool):
        return text.lower() in ("1", "true", "on", "yes")
    if isinstance(current, int):
        return int(text)
    if isinstance(current, float):
        return float(text)
    return text


def set_by_path(settings: config_mod.GraphicsSettings, key: str, value):
    """Return a new GraphicsSettings with dotted-path ``key`` replaced.
    Raises KeyError for unknown fields (the settings window only shows
    real settings)."""
    parts = key.split(".")

    def rec(node, parts):
        name = parts[0]
        if not any(f.name == name for f in dataclasses.fields(node)):
            raise KeyError(f"unknown setting: {key}")
        cur = getattr(node, name)
        if len(parts) == 1:
            return dataclasses.replace(node,
                                       **{name: _parse_value(cur, value)})
        return dataclasses.replace(node, **{name: rec(cur, parts[1:])})

    return rec(settings, parts).check()


class Session:
    """A live render session with runtime-mutable settings."""

    def __init__(self, settings: config_mod.GraphicsSettings,
                 output_width: int | None = None,
                 output_height: int | None = None,
                 host=None, seed: int = 0,
                 config_overrides: dict | None = None):
        self.settings = settings.check()
        self.output_width = output_width
        self.output_height = output_height
        self.config_overrides = dict(config_overrides or {})
        self.host = host if host is not None else myscene.build(seed=seed)
        self.pipe = self._make_pipeline()
        self.state = self.pipe.init_state(self.host)
        self.dyn = pipeline.default_dynamic(self.pipe.cfg)
        self._step = None
        self._pending_reset = False
        self.frame_count = 0

    # -- construction --------------------------------------------------------

    def _make_pipeline(self) -> pipeline.RenderPipeline:
        cfg = pipeline.PipelineConfig.from_settings(
            self.settings, output_width=self.output_width,
            output_height=self.output_height)
        if self.config_overrides:
            cfg = dataclasses.replace(cfg, **self.config_overrides)
        return pipeline.RenderPipeline(cfg)

    def default_pose(self) -> pipeline.CameraPose:
        return self.pipe.default_camera_pose(self.host)

    # -- mutation (the settings-window entry point) --------------------------

    def set(self, key: str, value) -> str:
        """Apply one setting change. Returns how it was applied:
        "dynamic" (no recompile), "static" (re-jit + history reset), or
        "realloc" (fresh temporal state)."""
        self.settings = set_by_path(self.settings, key, value)
        self.config_overrides.pop(_OVERRIDE_FOR_KEY.get(key, ""), None)
        if key in DYNAMIC_KEYS:
            field = key.split(".")[-1]
            self.dyn = self.dyn.replace(
                **{field: jnp.float32(
                    getattr(self.settings.post, field))})
            return "dynamic"

        old_cfg = self.pipe.cfg
        self.pipe = self._make_pipeline()
        self._step = None  # drop the stale executable (deferred re-init)
        if key in REALLOC_KEYS or self.pipe.cfg.render_width != \
                old_cfg.render_width or self.pipe.cfg.render_height != \
                old_cfg.render_height:
            # Buffer shapes changed: reallocate, carrying the simulation
            # (scene/physics/frame counter) across — OnRenderSizeChanged.
            fresh = self.pipe.init_state(self.host)
            self.state = fresh.replace(
                frame_index=self.state.frame_index,
                bodies=self.state.bodies,
                scene=self.state.scene,
                earth_gravity=self.state.earth_gravity,
                star_gravity=self.state.star_gravity)
            self.dyn = pipeline.default_dynamic(self.pipe.cfg)
            return "realloc"
        # Same shapes: keep state, reset temporal history next frame
        # (m_resetHistory semantics).
        self._pending_reset = True
        return "static"

    def reload_settings(self, path: str) -> list[str]:
        """Config-file reload: diff against the current settings and apply
        per-key (the file-watch analogue of the settings window)."""
        new = config_mod.load_settings(path)
        changed = []

        def diff(prefix, a, b):
            for f in dataclasses.fields(a):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                key = f"{prefix}{f.name}"
                if dataclasses.is_dataclass(va) and not isinstance(va, type):
                    diff(key + ".", va, vb)
                elif va != vb:
                    changed.append(key)

        diff("", self.settings, new)
        for key in changed:
            val = new
            for part in key.split("."):
                val = getattr(val, part)
            self.set(key, val)
        return changed

    # -- stepping -------------------------------------------------------------

    def jitted_step(self):
        """The jitted frame step: (state, pose, prev_pose, reset, dyn, dt)
        -> (state, image)."""
        pipe = self.pipe
        # dt is a traced argument — closing over it would bake the FIRST
        # call's timestep into the compiled step for the whole session
        # (StepTimer-fed dt must actually reach the physics).
        return jax.jit(lambda s, p, q, r, d, dt_: pipe.render_frame(
            s, p, dt_, prev_pose=q, reset=r, dyn=d))

    def step_args(self, pose=None, dt: float = 1.0 / 60.0, prev_pose=None):
        """Arguments of jitted_step() for the next frame."""
        if pose is None:
            pose = self.default_pose()
        return (self.state, pose,
                prev_pose if prev_pose is not None else pose,
                jnp.asarray(self._pending_reset), self.dyn, jnp.float32(dt))

    def step(self, pose: pipeline.CameraPose | None = None,
             dt: float = 1.0 / 60.0,
             prev_pose: pipeline.CameraPose | None = None):
        """Advance one frame; recompiles lazily after static changes."""
        if self._step is None:
            self._step = self.jitted_step()
        self.state, image = self._step(*self.step_args(pose, dt, prev_pose))
        self._pending_reset = False
        self.frame_count += 1
        return image
