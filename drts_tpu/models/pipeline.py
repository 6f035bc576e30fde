"""The flagship render pipeline: the frame orchestrator.

Redesign of the reference's App layer
(/root/reference/Source/App.cpp:144-643 Tick/Update/Render +
RenderScene:1111-1283 + PostProcessGraphics:1460-1525): the imperative frame
graph over command lists and ping-pong textures collapses into one pure
function ``state', image = render_frame(pipeline, state, camera_pose)``,
fully jittable. History swap (App.cpp:618-625) is functional state
threading; ``reset_history`` (App.cpp:667-679) reinitializes the state
pytree.

Frame graph (mirrors SURVEY.md §3.2/3.3/3.4):
  physics step -> scene pose refresh (TLAS-refit analogue) -> G-buffer ->
  [ReSTIR DI] -> path trace (with SHARC GI cache) -> denoise ->
  TAA upscale -> bloom -> tone map.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from ..utils import struct

from .. import config as config_mod
from ..ops import (camera as camera_mod, denoise, gbuffer, light as light_mod,
                   pathtrace, physics, post, restir, sharc as sharc_mod, taa)
from ..utils import math as m
from ..utils import rng as rng_mod
from . import myscene, scene as scene_mod


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline topology, derived from GraphicsSettings."""
    output_width: int = 1920
    output_height: int = 1080
    render_width: int = 1920
    render_height: int = 1080
    bounces: int = 8
    samples_per_pixel: int = 1
    russian_roulette: bool = True
    throughput_threshold: float = 1e-3
    # "None" | "NRDReBLUR" | "NRDReLAX" | "DLSSRayReconstruction" — each
    # enum selects a distinct code path (App.cpp:456,1628-1671): ReBLUR =
    # history-fade à-trous, ReLAX = variance-guided à-trous, DLSS-RR =
    # ReLAX core + joint denoise/upscale confidence coupling into TAA.
    denoiser: str = "NRDReBLUR"
    denoiser_max_history: int = 30
    denoiser_clamp_gamma: float = 2.5
    denoiser_specular_virtual: bool = True
    upscaling: bool = True
    # Temporal accumulation/upscale stage gate: "auto" runs TAA whenever
    # upscaling or a denoiser is active (the reference always has its
    # upscaler slot filled when either is on, App.cpp:1644-1708); "on" /
    # "off" force it — "on" lets a denoiser-off ablation keep temporal
    # accumulation so it bounds the denoiser's contribution, not the
    # accumulator's (ADVICE r3 medium).
    taa_mode: str = "auto"
    # History resample filter ("bilinear" | "catmull"). Catmull-Rom
    # reads 16 history pixels per output pixel against bilinear's 4, for
    # a marginal gain under motion, so bilinear ships; "catmull" stays
    # available for quality-first offline use.
    taa_history_filter: str = "bilinear"
    # TAA neighborhood variance-clip box size in std-devs (ops/taa
    # .TAAConfig.clip_gamma). The 1-sigma default pins history to the
    # current frame's local range — sweep candidate for the same orbit
    # plateau (a tight clip re-rejects well-reprojected history whenever
    # subpixel motion shifts the neighborhood statistics).
    taa_clip_gamma: float = 1.0
    # Motion-adaptive clip target (ops/taa.TAAConfig.clip_gamma_motion):
    # gamma blends from taa_clip_gamma (static) to this value at motion
    # saturation; < 0 disables. The default pair (0.2 at 0.25 px/frame)
    # was chosen by an orbiting-camera SSIM sweep (python -m
    # drts_tpu.fidelity --motion) that held both fidelity bars.
    taa_clip_gamma_motion: float = 0.2
    # Motion saturation scale for the adaptive clip, output px/frame
    # (ops/taa.TAAConfig.clip_motion_px).
    taa_clip_motion_px: float = 0.25
    # TAA current-frame blend weight floor (ops/taa.TAAConfig.blend_alpha):
    # lower = longer effective accumulation under motion.
    taa_blend_alpha: float = 0.1
    bloom_enabled: bool = True
    bloom_strength: float = 0.05
    sharpen_enabled: bool = True
    sharpness: float = 0.5
    # Lateral chromatic aberration in display space (README post chain);
    # 0 = off. Static: the per-channel center-scale gathers fold to
    # constant indices (ops/post.chromatic_aberration).
    chromatic_aberration_strength: float = 0.0
    tone_map_operator: str = "ACESFilmic"
    exposure: float = 1.0
    # HDR10 output path (App.cpp:1737-1744): ST.2084 + Rec.2020 signal.
    hdr_enabled: bool = False
    paper_white_nits: float = 200.0
    # "HDTV_to_UHDTV" | "DCI_P3_D65_to_UHDTV" | "HDTV_to_DCI_P3_D65"
    # (ToneMapPostProcess::ColorPrimaryRotation, App.cpp:2216-2225).
    hdr_color_rotation: str = "HDTV_to_UHDTV"
    # Thin-lens DoF (Camera.hlsli:43-54); 0 = pinhole.
    aperture_radius: float = 0.0
    focus_distance: float = 1.0
    jitter_enabled: bool = True
    physics_enabled: bool = True
    horizontal_fov_deg: float = 90.0
    block_size: int = 16384
    # Wavefront compaction start for the flagship trace (see
    # ops/pathtrace.PathTraceConfig.compact_from; 1 adds the coherence-
    # sorted bounce-1 segment — exact parity, machine-dependent net win).
    compact_from: int = 2
    # First SHARC-query bounce (ops/pathtrace.PathTraceConfig
    # .sharc_query_from; 1 = reference parity, 2 skips the dense
    # full-frame bounce-1 query). Default 2: the bounce-1 query runs over
    # every pixel while only a small share of bounce-1 lanes hit geometry
    # and find a cache entry. The op-level default stays 1 (reference
    # semantics); this is a product setting.
    sharc_query_from: int = 2
    halton_period: int = 64
    # ReSTIR DI (App.cpp:1187-1229 PrepareReSTIRDI + RTXDI::Render chain).
    restir_enabled: bool = True
    restir: restir.ReSTIRConfig = dataclasses.field(
        default_factory=restir.ReSTIRConfig)
    # Diagnostic view (ops/debugviz.py): "None" | "ReGIRCells" | "SHARC" |
    # "NRDValidation" — the reference's runtime correctness probes.
    debug_view: str = "None"
    # SHARC GI cache (Raytracing.ixx:114-148 sequencing).
    sharc_enabled: bool = True
    sharc: sharc_mod.SHARCConfig = dataclasses.field(
        default_factory=sharc_mod.SHARCConfig)
    sharc_downscale: int = 4
    # Update-trace cadence: 1 = every frame (reference parity,
    # Raytracing.ixx:114-148). N > 1 runs the downscaled update trace +
    # splat + resolve only on frames where frame_index % N == 0 (under
    # lax.cond — skip frames pay none of the update cost); the cache's
    # 64-frame staleness window (Source/SHARC.ixx:24) tolerates the
    # staler entries. Default 2: the static and orbit SSIM guards scored
    # the same as with every-frame updates (the cache serves a small share
    # of rays; a one-frame-staler cache is invisible), for half the
    # update cost on average.
    sharc_update_period: int = 2
    # Texture fetch cutoff bounce for the flagship trace (see
    # ops/pathtrace.PathTraceConfig.texture_bounces; 1 = bounce-1
    # material from constants).
    texture_bounces: int = 2

    @classmethod
    def from_settings(cls, s: config_mod.GraphicsSettings,
                      output_width: int | None = None,
                      output_height: int | None = None) -> "PipelineConfig":
        ow = output_width or s.render_width
        oh = output_height or s.render_height
        if (s.post.upscaler != config_mod.Upscaler.NONE
                and s.post.super_resolution_mode
                != config_mod.SuperResolutionMode.NATIVE):
            rw, rh = taa.render_size_for(ow, oh,
                                         s.post.super_resolution_mode.value)
        else:
            rw, rh = ow, oh
        r = s.restir_di
        return cls(
            output_width=ow, output_height=oh,
            render_width=rw, render_height=rh,
            restir_enabled=r.is_enabled,
            restir=restir.ReSTIRConfig(
                regir_cells_per_axis=r.regir_cells_per_axis,
                regir_cell_size=r.regir_cell_size,
                regir_build_samples=r.regir_build_samples,
                local_light_mode=r.local_light_mode.value,
                local_light_samples=r.local_light_samples,
                brdf_samples=r.brdf_samples,
                temporal_enabled=r.is_temporal_resampling_enabled,
                spatial_enabled=r.is_spatial_resampling_enabled,
                max_history=r.max_history_length,
                boiling_filter_strength=r.boiling_filter_strength,
                spatial_samples=r.spatial_samples,
                spatial_radius=r.spatial_radius,
                spatial_bias_correction=r.spatial_bias_correction,
                temporal_bias_correction=r.temporal_bias_correction,
                temporal_prev_surface=r.temporal_prev_surface,
                spatial_offset_mode=r.spatial_offset_mode),
            sharc_enabled=s.rtxgi == config_mod.RTXGITechnique.SHARC,
            sharc=sharc_mod.SHARCConfig(
                capacity_log2=s.sharc.capacity_log2,
                scene_scale=s.sharc.scene_scale,
                accumulation_frames=s.sharc.accumulation_frames,
                max_stale_frames=s.sharc.max_stale_frames,
                roughness_threshold=s.sharc.roughness_threshold,
                anti_firefly=s.sharc.is_anti_firefly_enabled),
            sharc_downscale=s.sharc.downscale_factor,
            bounces=s.raytracing.bounces,
            samples_per_pixel=s.raytracing.samples_per_pixel,
            russian_roulette=s.raytracing.is_russian_roulette_enabled,
            throughput_threshold=s.raytracing.throughput_threshold,
            denoiser=s.post.denoiser.value,
            denoiser_max_history=s.post.denoiser_max_history,
            denoiser_clamp_gamma=s.post.denoiser_clamp_gamma,
            denoiser_specular_virtual=s.post.denoiser_specular_virtual,
            upscaling=(rw, rh) != (ow, oh),
            bloom_enabled=s.post.is_bloom_enabled,
            bloom_strength=s.post.bloom_strength,
            sharpen_enabled=s.post.is_sharpening_enabled,
            sharpness=s.post.sharpness,
            chromatic_aberration_strength=(
                s.post.chromatic_aberration_strength),
            tone_map_operator=s.post.tone_map_operator.value,
            exposure=s.post.exposure,
            hdr_enabled=s.post.is_hdr_enabled,
            paper_white_nits=s.post.paper_white_nits,
            hdr_color_rotation=s.post.hdr_color_rotation.value,
            aperture_radius=s.camera.aperture_radius,
            focus_distance=s.camera.focus_distance,
            jitter_enabled=s.camera.is_jitter_enabled,
            horizontal_fov_deg=s.camera.horizontal_field_of_view,
        )


@struct.dataclass
class FrameState:
    """All cross-frame state (the 'functions-like-a-checkpoint' set from
    SURVEY.md §5.4: history textures, reservoirs, SHARC cache, physics
    world, frame counter — serializable as one pytree)."""
    frame_index: jnp.ndarray
    bodies: physics.RigidBodies
    scene: scene_mod.SphereScene
    denoiser: denoise.DenoiserState
    taa: taa.TAAState
    reservoirs: restir.Reservoirs
    prev_depth: jnp.ndarray      # (RH, RW) previous-frame linear depth
    prev_normal: jnp.ndarray     # (RH, RW, 3) previous-frame shading normal
    # Previous-frame packed surface rows (restir.pack_prev_material) for
    # REAL previous-surface temporal bias correction; a (1, 1, 7)
    # placeholder when the config doesn't use it (pytree shape is static
    # per pipeline instance).
    prev_surface_rows: jnp.ndarray
    sharc: sharc_mod.SHARCState
    earth_gravity: jnp.ndarray   # scalar bool toggles (MyScene.ixx userData)
    star_gravity: jnp.ndarray
    # Per-frame loss/cache counters (SURVEY.md §5.5; VERDICT r2 #9): keys
    # fixed by the static config (see _counter_keys) so the pytree
    # structure is stable across frames.
    counters: dict = struct.field(default_factory=dict)


@struct.dataclass
class DynamicSettings:
    """Per-frame tunable scalars (the ImGui sliders that do NOT change
    kernel topology, App.cpp:2128-2207): applied as traced values, so a
    runtime `set` takes effect without recompilation."""
    exposure: jnp.ndarray        # scalar
    bloom_strength: jnp.ndarray  # scalar
    sharpness: jnp.ndarray       # scalar


def default_dynamic(cfg: PipelineConfig) -> DynamicSettings:
    return DynamicSettings(
        exposure=jnp.float32(cfg.exposure),
        bloom_strength=jnp.float32(cfg.bloom_strength),
        sharpness=jnp.float32(cfg.sharpness))


@struct.dataclass
class CameraPose:
    """Dynamic camera inputs (position/orientation from the controller)."""
    position: jnp.ndarray  # (3,)
    forward: jnp.ndarray   # (3,)
    up: jnp.ndarray        # (3,)


class RenderPipeline:
    """Holds static config + Halton jitter table; all methods pure."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        # Jitter phase count follows the DLSS convention the reference uses
        # (App.cpp HaltonSamplePattern sized 8 x upscale-ratio^2): more
        # subpixel phases when the upscaler has more output pixels per
        # render pixel to reconstruct. halton_period is the no-upscaling
        # floor.
        ratio2 = ((cfg.output_width * cfg.output_height)
                  / max(cfg.render_width * cfg.render_height, 1))
        period = max(cfg.halton_period, int(round(8 * ratio2)))
        self.jitter_table = jnp.asarray(rng_mod.halton_jitter(period))

    # -- state management ---------------------------------------------------

    def _use_real_prev_surface(self) -> bool:
        """Whether FrameState carries real previous-frame surface rows for
        temporal pairwise bias correction (restir.pack_prev_material)."""
        c = self.cfg
        return (c.restir_enabled and c.restir.temporal_enabled
                and c.restir.temporal_bias_correction in ("pairwise",
                                                          "raytraced")
                and c.restir.temporal_prev_surface == "real")

    def _counter_keys(self):
        c = self.cfg
        keys = ["wavefront_overflow_paths"]
        if c.restir_enabled:
            keys += ["lights_dropped", "lights_dropped_power_frac"]
            if c.restir.local_light_mode == "ReGIR_RIS":
                keys += ["regir_occupancy"]
        if c.sharc_enabled:
            keys.append("sharc_splat_dropped_rows")
            for b in range(1, c.bounces + 1):
                keys += [f"sharc_hits_b{b}", f"sharc_queries_b{b}",
                         f"sharc_gate_b{b}", f"sharc_entry_b{b}"]
        return keys

    def init_state(self, host: myscene.MySceneHost | None = None,
                   seed: int = 0) -> FrameState:
        if host is None:
            host = myscene.build(seed=seed)
        c = self.cfg
        return FrameState(
            frame_index=jnp.int32(0),
            bodies=host.bodies,
            scene=host.scene,
            denoiser=denoise.init_state(c.render_height, c.render_width),
            taa=taa.init_state(c.output_height, c.output_width),
            reservoirs=restir.init_reservoirs(c.render_height,
                                              c.render_width),
            prev_depth=jnp.full((c.render_height, c.render_width), 1e8,
                                jnp.float32),
            prev_normal=jnp.zeros((c.render_height, c.render_width, 3),
                                  jnp.float32),
            prev_surface_rows=jnp.zeros(
                (c.render_height, c.render_width, 7)
                if self._use_real_prev_surface() else (1, 1, 7),
                jnp.float32),
            sharc=sharc_mod.init_state(c.sharc),
            earth_gravity=jnp.asarray(False),
            star_gravity=jnp.asarray(False),
            counters={k: jnp.float32(0.0) for k in self._counter_keys()},
        )

    def default_camera_pose(self, host: myscene.MySceneHost | None = None
                            ) -> CameraPose:
        pos = host.camera_position if host else (0.0, 0.0, -15.0)
        fwd = host.camera_forward if host else (0.0, 0.0, 1.0)
        return CameraPose(position=jnp.asarray(pos, jnp.float32),
                          forward=jnp.asarray(fwd, jnp.float32),
                          up=jnp.asarray((0.0, 1.0, 0.0), jnp.float32))

    def reset_history(self, state: FrameState) -> FrameState:
        """m_resetHistory (App.cpp:667-679): clears denoiser/TAA history,
        reservoirs, and the SHARC cache."""
        c = self.cfg
        return state.replace(
            denoiser=denoise.init_state(c.render_height, c.render_width),
            taa=taa.init_state(c.output_height, c.output_width),
            reservoirs=restir.init_reservoirs(c.render_height,
                                              c.render_width),
            prev_surface_rows=jnp.zeros_like(state.prev_surface_rows),
            sharc=sharc_mod.init_state(c.sharc))

    # -- per-frame ----------------------------------------------------------

    def _camera(self, state: FrameState, pose: CameraPose,
                prev_pose: CameraPose | None = None) -> camera_mod.Camera:
        c = self.cfg
        jitter = jnp.where(
            c.jitter_enabled,
            self.jitter_table[jnp.mod(state.frame_index,
                                      self.jitter_table.shape[0])],
            jnp.zeros(2, jnp.float32))
        # |forward| = focus distance (Camera.ixx frame convention); the
        # aperture radius turns the primary pass thin-lens (DoF).
        cam = camera_mod.make_camera(
            pose.position, pose.forward, pose.up,
            horizontal_fov_deg=c.horizontal_fov_deg,
            aspect=c.render_width / c.render_height, jitter=jitter,
            aperture_radius=c.aperture_radius,
            focus_distance=c.focus_distance)
        if prev_pose is not None:
            prev = camera_mod.make_camera(
                prev_pose.position, prev_pose.forward, prev_pose.up,
                horizontal_fov_deg=c.horizontal_fov_deg,
                aspect=c.render_width / c.render_height,
                focus_distance=c.focus_distance)
            cam = cam.replace(prev_position=prev.position,
                              prev_right=prev.right, prev_up=prev.up,
                              prev_forward=prev.forward)
        return cam

    # -- frame stages (profiled individually by profile_passes) -------------

    def _stage_update(self, state: FrameState, pose: CameraPose, dt,
                      prev_pose: CameraPose | None = None):
        """Physics + scene pose refresh (the TLAS-update analogue,
        App.cpp:556-557,605-608,972) + camera."""
        c = self.cfg
        if c.physics_enabled:
            bodies = physics.step(state.bodies, dt, state.earth_gravity,
                                  state.star_gravity)
        else:
            bodies = state.bodies
        if (state.scene.center.shape[0] == 0
                and state.scene.mesh_instances is not None):
            # All-mesh scene (myscene.as_mesh_scene): physics poses refit
            # the mesh-instance TLAS, not the (empty) sphere table.
            scene = myscene.sync_mesh_pose(state.scene, bodies.position,
                                           bodies.rotation)
        else:
            scene = scene_mod.advance_pose(state.scene, bodies.position,
                                           bodies.rotation)
        cam = self._camera(state, pose, prev_pose)
        return bodies, scene, cam

    def _stage_gbuffer(self, scene, cam, frame_index=0):
        c = self.cfg
        return gbuffer.generate(scene, cam, c.render_width, c.render_height,
                                c.block_size,
                                thin_lens=c.aperture_radius > 0.0,
                                frame_index=frame_index)

    def _restir_prepare(self, scene, cam, frame_index):
        """Light prep + ReGIR grid build (RTXDI.ixx:141-241 head). The
        grid only exists in ReGIR_RIS local-light mode (RTXDI.ixx:218);
        Uniform/Power_RIS draw candidates directly."""
        lights = light_mod.prepare(scene)
        if self.cfg.restir.local_light_mode == "ReGIR_RIS":
            grid = restir.build_regir_grid(lights, cam.position,
                                           self.cfg.restir, frame_index)
        else:
            grid = None
        return lights, grid

    def _restir_initial(self, gbuf, scene, lights, grid, frame_index):
        c = self.cfg
        surface = restir.make_surface(gbuf)
        cur = restir.initial_sampling(surface, scene, lights, grid,
                                      c.restir, frame_index,
                                      c.block_size)
        return surface, cur

    def _restir_temporal(self, state, cur, surface, lights, gbuf, reset,
                         frame_index, scene=None, cam=None):
        hist = jax.tree.map(lambda x: jnp.where(reset, jnp.zeros_like(x), x),
                            state.reservoirs)
        prev_material = None
        prev_cam_pos = None
        if self._use_real_prev_surface():
            prev_material = jnp.where(reset, 0.0, state.prev_surface_rows)
            prev_cam_pos = cam.prev_position if cam is not None else None
        return restir.temporal_resampling(
            cur, hist, surface, lights, gbuf.motion,
            state.prev_depth, state.prev_normal, self.cfg.restir,
            frame_index, scene=scene,
            block_size=self.cfg.block_size, prev_material=prev_material,
            prev_camera_position=prev_cam_pos)

    def _restir_spatial(self, cur, surface, lights, frame_index,
                        scene=None):
        return restir.spatial_resampling(cur, surface, lights,
                                         self.cfg.restir, frame_index,
                                         scene=scene,
                                         block_size=self.cfg.block_size)

    def _restir_final(self, cur, surface, scene, lights):
        return restir.final_shading(cur, surface, scene, lights,
                                    self.cfg.block_size)

    def _pt_cfg(self) -> pathtrace.PathTraceConfig:
        c = self.cfg
        return pathtrace.PathTraceConfig(
            width=c.render_width, height=c.render_height, bounces=c.bounces,
            samples_per_pixel=c.samples_per_pixel,
            russian_roulette=c.russian_roulette,
            throughput_threshold=c.throughput_threshold,
            block_size=c.block_size,
            compact_from=c.compact_from,
            texture_bounces=c.texture_bounces,
            sharc_query_from=c.sharc_query_from)

    def _stage_sharc(self, state, scene, cam, di_total, frame_index):
        """SHARC update trace + resolve at downscaled res
        (Raytracing.ixx:114-148)."""
        c = self.cfg
        su_cfg = dataclasses.replace(
            self._pt_cfg(),
            width=max(1, c.render_width // c.sharc_downscale),
            height=max(1, c.render_height // c.sharc_downscale))

        def do(sharc_st):
            return pathtrace.sharc_update_trace(
                scene, cam, sharc_st, c.sharc, su_cfg, frame_index,
                di_radiance=di_total)

        if c.sharc_update_period <= 1:
            return do(state.sharc)
        # Cadence gate: the whole update subgraph under lax.cond — XLA
        # executes only the taken branch, so skip frames pay nothing.
        # Skip-frame counters are zeros (rates average over the cadence).
        shapes = jax.eval_shape(do, state.sharc)

        def skip(sharc_st):
            return sharc_st, jax.tree.map(
                lambda sh: jnp.zeros(sh.shape, sh.dtype), shapes[1])

        return jax.lax.cond(
            jnp.mod(frame_index, c.sharc_update_period) == 0, do, skip,
            state.sharc)

    def _stage_trace(self, scene, cam, gbuf, sharc_state, di_total,
                     frame_index):
        c = self.cfg
        return pathtrace.trace_image(
            scene, cam, self._pt_cfg(), frame_index, gbuf=gbuf,
            sharc_state=sharc_state if c.sharc_enabled else None,
            sharc_cfg=c.sharc if c.sharc_enabled else None,
            di_radiance=di_total,
            di_in_radiance=(c.denoiser == "None"))

    def _stage_denoise(self, state, out, gbuf, cam, di_diffuse, di_specular,
                       reset):
        """Demodulated denoise + compose (Raytracing.hlsl:400-413 +
        NRDComposition)."""
        # Split indirect radiance into demodulated diffuse/specular
        # channels (Raytracing.hlsl:400-413 + NRDComposition pack).
        indirect = jnp.maximum(out.radiance - out.primary_radiance, 0.0)
        hd = jnp.where(jnp.isfinite(out.hit_distance), out.hit_distance,
                       0.0)
        diffuse_chan = jnp.where(out.is_diffuse[..., None], indirect, 0.0)
        specular_chan = jnp.where(out.is_diffuse[..., None], 0.0, indirect)
        if di_diffuse is not None:
            # direct + indirect per channel (Raytracing.hlsl:407-412).
            diffuse_chan = diffuse_chan + di_diffuse
            specular_chan = specular_chan + di_specular
        d_diff, d_spec = denoise.demodulate(
            diffuse_chan, specular_chan,
            out.primary_albedo, out.primary_f_env)
        diff4 = jnp.concatenate([d_diff, hd[..., None]], axis=-1)
        spec4 = jnp.concatenate([d_spec, hd[..., None]], axis=-1)
        c = self.cfg
        tuned = dict(max_accumulated_frames=c.denoiser_max_history,
                     clamp_gamma=c.denoiser_clamp_gamma,
                     specular_virtual=c.denoiser_specular_virtual)
        if c.denoiser == "NRDReLAX":
            den_fn = denoise.denoise_relax
            den_cfg = denoise.DenoiseConfig(**tuned)
        elif c.denoiser == "DLSSRayReconstruction":
            # Joint mode: lighter spatial core; the temporal upscaler gets
            # the denoiser's history confidence (see _stage_post).
            den_fn = denoise.denoise_relax
            den_cfg = denoise.DenoiseConfig(relax_atrous_iterations=3,
                                            **tuned)
        else:
            den_fn, den_cfg = denoise.denoise, denoise.DenoiseConfig(**tuned)
        # Virtual-point specular motion (NRD ReBLUR's specular motion
        # model): reflections reproject from Xv = X + view * hitDist.
        rw, rh = c.render_width, c.render_height

        def prev_px_of(xv):
            prev_ndc, _ = camera_mod.project_to_ndc(cam, xv, previous=True)
            cur_ndc, _ = camera_mod.project_to_ndc(cam, xv, previous=False)
            return (camera_mod.ndc_to_pixel(prev_ndc, rw, rh),
                    camera_mod.ndc_to_pixel(cur_ndc, rw, rh))

        motion_spec = denoise.virtual_specular_motion(
            gbuf.motion, out.primary_position, gbuf.ray_direction,
            out.hit_distance, prev_px_of)
        den_state, f_diff, f_spec = den_fn(
            state.denoiser, diff4, spec4, gbuf.motion,
            out.primary_normal, gbuf.linear_depth, out.primary_valid,
            gbuf.mat.roughness, reset, den_cfg,
            motion_specular=motion_spec)
        color = denoise.compose(out.primary_radiance, f_diff, f_spec,
                                out.primary_albedo, out.primary_f_env,
                                out.primary_valid)
        if c.denoiser == "DLSSRayReconstruction":
            confidence = den_state.history_length / 30.0
        else:
            confidence = None
        return den_state, color, confidence

    def _stage_taa(self, state, color, gbuf, cam, reset, confidence=None):
        """TAA upscale (the DLSS-SR/XeSS slot, App.cpp:1644-1708)."""
        c = self.cfg
        taa_state = state.taa
        use_taa = {"auto": c.upscaling or c.denoiser != "None",
                   "on": True, "off": False}[c.taa_mode]
        if use_taa:
            taa_state, color = taa.upscale(
                state.taa, color, gbuf.motion, cam.jitter,
                c.output_height, c.output_width, reset,
                cfg=taa.TAAConfig(history_filter=c.taa_history_filter,
                                  clip_gamma=c.taa_clip_gamma,
                                  clip_gamma_motion=c.taa_clip_gamma_motion,
                                  clip_motion_px=c.taa_clip_motion_px,
                                  blend_alpha=c.taa_blend_alpha),
                confidence=confidence)
        elif (c.output_height, c.output_width) != (c.render_height,
                                                   c.render_width):
            color = post.resize_bilinear(color, c.output_height,
                                         c.output_width)
        return taa_state, color

    def _stage_postfx(self, color, dyn: DynamicSettings | None = None):
        """Sharpen + bloom + tone map (App.cpp:1498-1514)."""
        c = self.cfg
        if dyn is None:
            dyn = default_dynamic(c)
        if c.sharpen_enabled:
            color = post.sharpen(color, dyn.sharpness)
        if c.bloom_enabled:
            color = post.bloom(color, dyn.bloom_strength)
        color = post.tonemap(color, c.tone_map_operator, dyn.exposure,
                             hdr=c.hdr_enabled,
                             paper_white_nits=c.paper_white_nits,
                             color_rotation=c.hdr_color_rotation)
        # Display-space lateral CA last (reference README post chain).
        return post.chromatic_aberration(color,
                                         c.chromatic_aberration_strength)

    def _stage_post(self, state, color, gbuf, cam, reset, confidence=None,
                    dyn: DynamicSettings | None = None):
        """TAA upscale + bloom/sharpen/tonemap
        (PostProcessGraphics, App.cpp:1460-1525)."""
        taa_state, color = self._stage_taa(state, color, gbuf, cam, reset,
                                           confidence)
        return taa_state, self._stage_postfx(color, dyn)

    def render_frame(self, state: FrameState, pose: CameraPose,
                     dt=1.0 / 60.0, prev_pose: CameraPose | None = None,
                     reset=False, dyn: DynamicSettings | None = None,
                     _run=None):
        """One full App::Tick (update + render + post). Pure; jittable.

        ``_run(name, fn, *args)`` optionally wraps every frame-graph stage
        (the PIX-scoped-event seam, App.cpp:598): profile_passes injects a
        jit-and-time hook here so per-pass timing exercises the EXACT same
        dataflow as the monolithic frame — no hand-mirrored graph to drift.

        Returns (new_state, output image (OH, OW, 3) in display [0,1])."""
        c = self.cfg
        reset = jnp.asarray(reset)
        run = _run if _run is not None else (lambda name, fn, *args: fn(*args))
        fi = state.frame_index

        bodies, scene, cam = run(
            "update", lambda s, p: self._stage_update(s, p, dt, prev_pose),
            state, pose)

        # --- RenderScene (App.cpp:1111-1283) --------------------------------
        gbuf = run("gbuffer",
                   lambda s, cm: self._stage_gbuffer(s, cm, fi), scene, cam)

        # ReSTIR DI chain (RTXDI.ixx:141-241): light prep -> ReGIR build ->
        # initial -> temporal -> spatial -> final shading.
        di_total = None
        di_diffuse = di_specular = None
        reservoirs = state.reservoirs
        if c.restir_enabled:
            lights, grid = run(
                "restir_prepare",
                lambda s, cm: self._restir_prepare(s, cm, fi), scene, cam)
            surface, cur = run(
                "restir_initial",
                lambda g, s, li, gr: self._restir_initial(g, s, li, gr, fi),
                gbuf, scene, lights, grid)
            if c.restir.temporal_enabled:
                cur = run(
                    "restir_temporal",
                    lambda st, cu, su, li, g, s2, cm:
                    self._restir_temporal(st, cu, su, li, g, reset, fi, s2,
                                          cm),
                    state, cur, surface, lights, gbuf, scene, cam)
            if c.restir.spatial_enabled:
                cur = run(
                    "restir_spatial",
                    lambda cu, su, li, s: self._restir_spatial(
                        cu, su, li, fi, s),
                    cur, surface, lights, scene)
            di_diffuse, di_specular = run(
                "restir_final",
                lambda cu, su, s, li: self._restir_final(cu, su, s, li),
                cur, surface, scene, lights)
            di_total = di_diffuse + di_specular
            reservoirs = cur

        # SHARC GI cache: update pass at downscaled res, then resolve, then
        # the main trace queries the fresh cache (Raytracing.ixx:114-148).
        sharc_state = state.sharc
        frame_counters = {}
        if c.restir_enabled and lights.dropped_lights is not None:
            # MAX_LIGHTS cap accounting (light.py prepare): emitters cut
            # from the compact table, surfaced instead of silently lost.
            frame_counters["lights_dropped"] = lights.dropped_lights
            frame_counters["lights_dropped_power_frac"] = \
                lights.dropped_power_frac
        if c.restir_enabled and grid is not None:
            # ReGIR grid occupancy (the reference inspects this via the
            # cell-visualization overlay, DIFinalShading.hlsl:69-75): the
            # fraction of non-fallback cell slots holding a live reservoir.
            n_cells = c.restir.regir_cells_per_axis ** 3
            frame_counters["regir_occupancy"] = jnp.mean(
                (grid.weight[:n_cells] > 0).astype(jnp.float32))
        if c.sharc_enabled:
            if di_total is not None:
                sharc_state, sharc_counters = run(
                    "sharc_update",
                    lambda st, s, cm, di: self._stage_sharc(st, s, cm, di,
                                                            fi),
                    state, scene, cam, di_total)
            else:
                sharc_state, sharc_counters = run(
                    "sharc_update",
                    lambda st, s, cm: self._stage_sharc(st, s, cm, None, fi),
                    state, scene, cam)
            frame_counters.update(sharc_counters)

        if di_total is not None:
            out = run(
                "trace",
                lambda s, cm, g, sh, di: self._stage_trace(s, cm, g, sh, di,
                                                           fi),
                scene, cam, gbuf, sharc_state, di_total)
        else:
            out = run(
                "trace",
                lambda s, cm, g, sh: self._stage_trace(s, cm, g, sh, None,
                                                       fi),
                scene, cam, gbuf, sharc_state)

        # --- PostProcessGraphics (App.cpp:1460-1525) -------------------------
        den_state = state.denoiser
        confidence = None
        if c.denoiser != "None":
            if di_diffuse is not None:
                den_state, color, confidence = run(
                    "denoise",
                    lambda st, o, g, cm, dd, ds: self._stage_denoise(
                        st, o, g, cm, dd, ds, reset),
                    state, out, gbuf, cam, di_diffuse, di_specular)
            else:
                den_state, color, confidence = run(
                    "denoise",
                    lambda st, o, g, cm: self._stage_denoise(
                        st, o, g, cm, None, None, reset),
                    state, out, gbuf, cam)
        else:
            color = out.radiance

        if confidence is not None:
            taa_state, color = run(
                "taa",
                lambda st, cl, g, cm, cf: self._stage_taa(st, cl, g, cm,
                                                          reset, cf),
                state, color, gbuf, cam, confidence)
        else:
            taa_state, color = run(
                "taa",
                lambda st, cl, g, cm: self._stage_taa(st, cl, g, cm, reset),
                state, color, gbuf, cam)
        if dyn is not None:
            image = run("post",
                        lambda cl, d: self._stage_postfx(cl, d), color, dyn)
        else:
            image = run("post", lambda cl: self._stage_postfx(cl), color)

        # Diagnostic overlays (DIFinalShading.hlsl:69-75,
        # Raytracing.hlsl:279-284, App.cpp:1522-1524).
        if c.debug_view != "None":
            from ..ops import debugviz
            if (c.debug_view == "ReGIRCells" and c.restir_enabled
                    and grid is not None):
                dbg = debugviz.regir_cells(grid, gbuf.surf.position,
                                           gbuf.surf.valid,
                                           c.restir.regir_cells_per_axis)
                image = post.resize_bilinear(dbg, c.output_height,
                                             c.output_width)
            elif c.debug_view == "SHARC" and c.sharc_enabled:
                front = jnp.where(gbuf.surf.is_front_face[..., None],
                                  gbuf.surf.geometric_normal,
                                  -gbuf.surf.geometric_normal)
                dbg = debugviz.sharc_voxels(gbuf.surf.position, front,
                                            cam.position, gbuf.surf.valid,
                                            c.sharc)
                image = post.resize_bilinear(dbg, c.output_height,
                                             c.output_width)
            elif c.debug_view == "NRDValidation" and c.denoiser != "None":
                image = debugviz.validation_overlay(
                    image, den_state.history_length)

        frame_counters.update(out.counters)
        counters = {k: jnp.float32(frame_counters.get(k, 0.0))
                    for k in self._counter_keys()}
        new_state = FrameState(
            frame_index=state.frame_index + 1,
            bodies=bodies, scene=scene, denoiser=den_state, taa=taa_state,
            reservoirs=reservoirs,
            prev_depth=jnp.where(jnp.isfinite(gbuf.linear_depth),
                                 gbuf.linear_depth, 1e8),
            prev_normal=out.primary_normal,
            prev_surface_rows=(restir.pack_prev_material(gbuf)
                               if self._use_real_prev_surface()
                               else state.prev_surface_rows),
            sharc=sharc_state,
            earth_gravity=state.earth_gravity,
            star_gravity=state.star_gravity,
            counters=counters)
        return new_state, image

    # -- per-pass profiling (SURVEY §5.1/§5.5; the PIX-timing analogue) ------

    def profile_passes(self, state: FrameState, pose: CameraPose,
                       dt=1.0 / 60.0, iters: int = 4) -> dict:
        """Time each frame-graph pass as its own jitted call (device-synced).

        Returns {pass_name: ms}. A pass that fails raises. Stages come
        straight from render_frame's ``_run`` hook — the same dataflow as
        the monolithic frame, nothing hand-mirrored. The sum slightly
        exceeds the monolithic jit's frame time because XLA can't overlap
        across the sync boundaries here.
        """
        import time as _time
        timings: dict = {}

        def timed(name, fn, *args):
            jfn = jax.jit(fn)
            out = jfn(*args)  # compile + warm
            jax.block_until_ready(out)
            t0 = _time.perf_counter()
            for _ in range(iters):
                out = jfn(*args)
            jax.block_until_ready(out)
            timings[name] = (_time.perf_counter() - t0) / iters * 1e3
            return out

        self.render_frame(state, pose, dt, _run=timed)
        return timings

    def render_frame_jit(self):
        """Jitted render_frame closure (static self via closure capture)."""
        return jax.jit(lambda state, pose, dt, reset:
                       self.render_frame(state, pose, dt, reset=reset))
